"""PyTorch port: the autoscaler (``serve/autoscaler.py``) and the
resilience primitives (``serve/resilience.py``) against the JAX package.

* The four tier-1 cases of the JAX package's autoscaler tests on port
  replicas: scale up on sustained overload and back down when idle,
  replace dead capacity (the cooldown does not block it), contain and
  quarantine a failing spawn (on a fake clock), the cooldown and the
  config's validation.
* The same scripted fleet history through both packages' router and
  autoscaler, over replicas that serve nothing (they shed, idle or die
  on cue): the same decision at every tick.
* ``RetryPolicy`` (backoff with seeded jitter under one deadline budget,
  on a fake clock and sleep) and ``CircuitBreaker`` (closed / open /
  half-open / exhausted) step through the same states in both packages.
"""

import asyncio
import random

import pytest

from torch_fleet_common import SERVE, Models, prompts

from deepspeed_tpu_torch.telemetry import get_registry

S = SERVE["torch"]


@pytest.fixture(scope="module")
def models():
    return Models()


def _tight_config():
    """Admission tight enough that a small burst sheds."""
    return S.ServingConfig(
        token_budget=64, chunk=16, max_inflight=1,
        admission=S.AdmissionConfig(max_pending=1, max_queued_tokens=32,
                                    retry_after_s=0.05))


def _factory(models):
    async def make(name):
        return S.Replica(name, models.torch_engine(), _tight_config())
    return make


async def _burst(router, base, streams=None):
    for i in range(8):
        try:
            s = await router.submit(prompts((12,), seed=base + i)[0], 8)
            if streams is not None:
                streams.append(s)
        except S.OverloadedError:
            pass


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_autoscaler_scales_up_on_overload_and_down_on_idle(models):
    # the router backs a shedding replica off on its own clock: a fake one,
    # moved past the retry hint before the traffic after the bursts
    clock = _Clock()

    async def run():
        router = S.ReplicaRouter(
            [S.Replica("base0", models.torch_engine(), _tight_config())],
            S.RouterConfig(monitor_interval_s=0.0, default_backoff_s=0.0),
            clock=clock)
        await router.start()
        scaler = S.Autoscaler(
            router, _factory(models),
            S.AutoscalerConfig(min_replicas=1, max_replicas=3,
                               scale_up_after_ticks=2,
                               scale_down_after_ticks=3, cooldown_s=0.0))
        reg = get_registry()
        up0 = reg.family_total("router_autoscale_up_total")
        down0 = reg.family_total("router_autoscale_down_total")
        try:
            streams = []
            await _burst(router, 0, streams)
            d1 = await scaler.tick()
            assert d1["pressure_ticks"] == 1 and d1["action"] == "none"
            await _burst(router, 100, streams)
            d2 = await scaler.tick()
            assert d2["action"].startswith("up:")
            assert len(router.replicas) == 2
            assert router._by_name[d2["action"].split(":", 1)[1]].state \
                == "up"
            assert reg.family_total("router_autoscale_up_total") - up0 == 1
            for s in streams:
                await s.drain()
            clock.t += 1.0
            await (await router.submit(prompts((10,), seed=99)[0],
                                       4)).drain()
            downs = []
            for _ in range(10):
                d = await scaler.tick()
                if d["action"].startswith("down:"):
                    downs.append(d["action"])
                    if len(router.replicas) == 1:
                        break
            assert downs and len(router.replicas) == 1
            assert reg.family_total("router_autoscale_down_total") \
                - down0 >= 1
            for _ in range(5):
                assert not (await scaler.tick())["action"].startswith(
                    "down:")
            toks = await (await router.submit(prompts((9,), seed=7)[0],
                                              4)).drain()
            assert len(toks) == 4
        finally:
            await scaler.stop()
            await router.stop()

    asyncio.run(run())


def test_autoscaler_replaces_dead_capacity(models):
    async def run():
        replica = S.Replica("base0", models.torch_engine(), _tight_config())
        router = S.ReplicaRouter([replica],
                                 S.RouterConfig(monitor_interval_s=0.0))
        await router.start()
        scaler = S.Autoscaler(router, _factory(models), S.AutoscalerConfig(
            min_replicas=1, max_replicas=2, cooldown_s=30.0))
        try:
            replica.serving.loop_runner.request_stop()
            replica.serving.loop_runner.join(10.0)
            assert not replica.alive()
            d = await scaler.tick()
            assert d["action"].startswith("up:")
            assert replica.state == "dead"
            up = [r for r in router.replicas if r.state == "up"]
            assert len(up) == 1
            s = await router.submit(prompts((11,), seed=3)[0], 4)
            assert len(await s.drain()) == 4 and s.replica == up[0].name
        finally:
            await scaler.stop()
            await router.stop()

    asyncio.run(run())


def test_autoscaler_spawn_failure_contained_and_quarantined(models):
    async def run():
        clock = _Clock()
        router = S.ReplicaRouter(
            [S.Replica("base0", models.torch_engine(), _tight_config())],
            S.RouterConfig(monitor_interval_s=0.0, default_backoff_s=0.0))
        await router.start()
        calls = []

        async def bad_factory(name):
            calls.append(name)
            raise RuntimeError("factory exploded: no capacity")

        scaler = S.Autoscaler(
            router, bad_factory,
            S.AutoscalerConfig(min_replicas=1, max_replicas=3,
                               scale_up_after_ticks=1, cooldown_s=0.0,
                               spawn_backoff_s=5.0,
                               spawn_backoff_max_s=30.0), clock=clock)
        reg = get_registry()
        fail0 = reg.family_total("router_autoscale_spawn_failures_total")
        try:
            await _burst(router, 0)
            d = await scaler.tick()
            assert d["action"].startswith("up_failed:")
            assert "factory exploded" in d["spawn_error"]
            assert reg.family_total(
                "router_autoscale_spawn_failures_total") - fail0 == 1
            assert len(calls) == 1 and len(router.replicas) == 1
            await _burst(router, 100)
            d = await scaler.tick()
            assert d["action"] == "none" and len(calls) == 1
            assert d["spawn_quarantine_s"] > 0
            clock.t += 5.1
            await _burst(router, 200)
            d = await scaler.tick()
            assert d["action"].startswith("up_failed:") and len(calls) == 2
            assert d["spawn_quarantine_s"] == pytest.approx(10.0, abs=0.5)
            router.replicas[0].serving.loop_runner.request_stop()
            router.replicas[0].serving.loop_runner.join(10.0)
            d = await scaler.tick()
            assert d["action"] == "none" and len(calls) == 2
            clock.t += 10.1
            d = await scaler.tick()
            assert d["action"].startswith("up_failed:") and len(calls) == 3
        finally:
            await scaler.stop()
            await router.stop()

    asyncio.run(run())


def test_autoscaler_cooldown_and_config_validation(models):
    for bad in (dict(min_replicas=0), dict(min_replicas=2, max_replicas=1)):
        with pytest.raises(ValueError):
            S.Autoscaler(object.__new__(S.ReplicaRouter), _factory(models),
                         S.AutoscalerConfig(**bad))

    async def run():
        router = S.ReplicaRouter(
            [S.Replica("base0", models.torch_engine(), _tight_config())],
            S.RouterConfig(monitor_interval_s=0.0, default_backoff_s=0.0))
        await router.start()
        scaler = S.Autoscaler(router, _factory(models), S.AutoscalerConfig(
            min_replicas=1, max_replicas=3, scale_up_after_ticks=1,
            cooldown_s=3600.0))
        try:
            await _burst(router, 0)
            assert (await scaler.tick())["action"].startswith("up:")
            await _burst(router, 10)
            assert (await scaler.tick())["action"] == "none"
            assert len(router.replicas) == 2
        finally:
            await scaler.stop()
            await router.stop()

    asyncio.run(run())


# ---------------------------------------------------------------------------
# the same decisions as the JAX package on one scripted fleet history
# ---------------------------------------------------------------------------
class _Scripted:
    """A replica that serves nothing: it sheds while ``busy``, reads as
    dead once ``dead``, and drains and stops at once."""

    def __init__(self, serve, name, fleet):
        self.serve, self.name, self.fleet = serve, name, fleet
        self.block_size = 16
        self.state = "up"
        self.started = False
        self.registry = None
        self.weight_version = 0

    async def start(self):
        self.started = True
        return self

    async def drain(self):
        pass

    async def stop(self):
        pass

    async def kill(self):
        pass

    def reap(self):
        pass

    async def refresh(self, force=False):
        pass

    def alive(self):
        return self.name not in self.fleet["dead"]

    def heartbeat_age(self):
        return None

    def load(self):
        return 0.0

    def health(self):
        return {"name": self.name, "state": self.state}

    def spill_summary(self):
        return None

    async def submit(self, prompt, max_new_tokens, **kw):
        raise self.serve.OverloadedError("queue_full", "scripted",
                                         retry_after_s=0.0)


def _scripted_history(pkg):
    serve = SERVE[pkg]
    fleet = {"dead": set()}
    clock = _Clock()

    async def factory(name):
        return _Scripted(serve, name, fleet)

    async def run():
        router = serve.ReplicaRouter(
            [_Scripted(serve, "base0", fleet)],
            serve.RouterConfig(monitor_interval_s=0.0,
                               default_backoff_s=0.0))
        await router.start()
        scaler = serve.Autoscaler(router, factory, serve.AutoscalerConfig(
            min_replicas=1, max_replicas=3, scale_up_after_ticks=2,
            scale_down_after_ticks=2, cooldown_s=1.0), clock=clock)
        out = []
        script = ["burst", "burst", "burst", "idle", "burst", "burst",
                  "idle", "idle", "idle", "kill", "idle", "idle", "idle",
                  "idle", "burst", "burst"]
        for step in script:
            clock.t += 0.6
            if step == "burst":
                for i in range(3):
                    try:
                        await router.submit([1 + i, 2, 3], 4)
                    except serve.OverloadedError:
                        pass
            elif step == "kill":
                fleet["dead"].add(router.replicas[0].name)
            d = await scaler.tick()
            out.append((d["action"], d["up_replicas"], d["pressure_ticks"],
                        d["idle_ticks"], sorted(r.name for r in
                                                router.replicas)))
        await scaler.stop()
        await router.stop()
        return out

    return asyncio.run(run())


def test_autoscaler_decisions_match_jax():
    got = _scripted_history("torch")
    assert got == _scripted_history("jax")
    actions = [a for a, *_ in got]
    assert any(a.startswith("up:") for a in actions)
    assert any(a.startswith("down:") for a in actions)


def test_retry_policy_and_circuit_breaker_match_jax():
    def trace(serve):
        from importlib import import_module
        res = import_module(serve.__name__ + ".resilience")
        clock = _Clock()
        sleeps = []

        async def sleep(s):
            sleeps.append(round(s, 12))
            clock.t += s

        policy = res.RetryPolicy(
            res.RetryConfig(max_attempts=5, base_backoff_s=0.1,
                            max_backoff_s=0.5, jitter=0.5, deadline_s=2.0),
            clock=clock, sleep=sleep, rng=random.Random(3))
        fails = {"n": 0}

        async def flaky(budget):
            fails["n"] += 1
            clock.t += 0.05
            if fails["n"] < 4:
                raise ConnectionResetError("reset")
            return round(budget, 12)

        got = asyncio.run(policy.call(flaky, call="t"))
        breaker = res.CircuitBreaker(res.BreakerConfig(
            failure_threshold=2, open_s=1.0, max_open_cycles=2),
            clock=clock)
        states = []
        for event in ("f", "f", "p", "t", "p", "f", "t", "p", "f", "s",
                      "f", "f", "t", "p", "f"):
            if event == "f":
                breaker.record_failure()
            elif event == "s":
                breaker.record_success()
            elif event == "t":
                clock.t += 1.5
            else:
                states.append(breaker.allow_probe())
            states.append(tuple(sorted(breaker.snapshot().items())))
        return sleeps, got, states

    assert trace(SERVE["torch"]) == trace(SERVE["jax"])

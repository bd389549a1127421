"""PyTorch port: the offline tuner, workload capture / replay, the online
adapter and the tunable registry's search half against the JAX package
(``tests/unit/autotuning/test_autotune.py``, ``test_online.py`` and
``tests/unit/runtime/test_tunables.py``, case for case).

Held: ``synthesize`` / ``replay_schedule`` / ``simulate_queue`` equal to
JAX's for a seed (bit for bit: the same numpy draws and arithmetic); the
recorder capture and the artifact round trip; the ``OfflineTuner`` report,
trial count and winning config equal to JAX's (its cost models run on the
port's bucket and prefetch planners); the tuned config loads in the
port's ``DeepSpeedConfig`` with provenance "tuned"; ``OnlineAdapter``
decisions equal to JAX's tick for tick under the same injected clock and
burn sequence; the registry's ``clamp`` / ``ladder`` / ``effective`` equal
to JAX's over every knob. The serving runtime with ``ServingConfig.
autotune`` builds the adapter and the loop ticks it.
"""

import asyncio
import json
import types

import numpy as np
import pytest

from deepspeed_tpu import autotuning as jat
from deepspeed_tpu.inference.v2.serve import admission as jadm
from deepspeed_tpu.runtime import tunables as jtun
from deepspeed_tpu import telemetry as jtel

from torch_fleet_common import Models

from deepspeed_tpu_torch import autotuning as tat
from deepspeed_tpu_torch.inference.v2 import serve as tserve
from deepspeed_tpu_torch.inference.v2.serve import admission as tadm
from deepspeed_tpu_torch.runtime import tunables as ttun
from deepspeed_tpu_torch import telemetry as ttel

PKGS = {"jax": (jat, jadm, jtun, jtel), "torch": (tat, tadm, ttun, ttel)}


@pytest.fixture
def artifact():
    return jat.synthesize(requests=32, rate=64.0, seed=7)


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh metric registries and recorders in both packages, no steady
    state, no observations: the adapter reads them."""
    prev = [(tel.set_registry(tel.MetricsRegistry()),
             tel.set_recorder(tel.FlightRecorder()), tel)
            for _, _, _, tel in PKGS.values()]
    for _, _, tun, tel in PKGS.values():
        tel.watchdog.reset()
        tun.REGISTRY.reset_observations()
    yield
    for reg, rec, tel in prev:
        tel.watchdog.reset()
        tel.set_recorder(rec)
        tel.set_registry(reg)
    for _, _, tun, _ in PKGS.values():
        tun.REGISTRY.reset_observations()


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(requests=16, seed=3),
                                dict(requests=64, rate=8.0, seed=11,
                                     long_frac=0.5, tenants=("a", "b"))])
def test_synthesize_and_replay_equal_jax(kw):
    art = tat.synthesize(**kw)
    assert art == jat.synthesize(**kw)
    assert art != tat.synthesize(**dict(kw, seed=kw["seed"] + 1))
    sched = tat.replay_schedule(art)
    assert json.dumps(sched, sort_keys=True) == \
        json.dumps(jat.replay_schedule(art), sort_keys=True)
    assert [r["t"] for r in sched] == sorted(r["t"] for r in sched)
    for r in sched:
        assert len(r["prompt"]) == r["prompt_len"]
    assert tat.replay_schedule(art, vocab=100) == \
        jat.replay_schedule(art, vocab=100)


@pytest.mark.parametrize("budget,cap", [(32, None), (64, None), (4096, None),
                                        (64, 64), (256, 2048)])
def test_simulate_queue_equal_jax(artifact, budget, cap):
    sched = tat.replay_schedule(artifact)
    got = tat.simulate_queue(sched, budget, max_queued_tokens=cap)
    assert got == jat.simulate_queue(sched, budget, max_queued_tokens=cap)
    if cap is not None and cap <= 64:
        assert got["shed_fraction"] > 0.0
    with pytest.raises(ValueError, match="empty"):
        tat.simulate_queue([], budget)


def test_save_load_and_capture_from_recorder(artifact, tmp_path):
    p = str(tmp_path / "wl.json")
    tat.save(artifact, p)
    assert tat.load(p) == artifact == jat.load(p)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99, "requests": [{}]}))
    with pytest.raises(ValueError, match="version"):
        tat.load(str(bad))
    bad.write_text(json.dumps({"version": tat.ARTIFACT_VERSION,
                               "requests": []}))
    with pytest.raises(ValueError, match="no requests"):
        tat.load(str(bad))
    arts = {}
    for name, (at, _, _, tel) in PKGS.items():
        rec = tel.FlightRecorder()
        with pytest.raises(ValueError, match="no request_submit"):
            at.capture_from_recorder(rec)
        rec.record("request_submit", uid=1, prompt_tokens=10,
                   max_new_tokens=4)
        rec.record("request_submit", uid=2, prompt_tokens=200,
                   max_new_tokens=16, tenant="team-b")
        rec.record("train_bucket", tokens=4096)
        arts[name] = at.capture_from_recorder(rec)
    art = arts["torch"]
    assert art["requests"][0]["t"] == 0.0
    assert art["requests"][1]["prompt_len"] == 200
    assert art["requests"][1]["tenant"] == "team-b"
    assert art["train"] == {"bucket_shapes": [4096]}
    assert art["meta"] == arts["jax"]["meta"]
    assert [{k: v for k, v in r.items() if k != "t"}
            for r in art["requests"]] == \
        [{k: v for k, v in r.items() if k != "t"}
         for r in arts["jax"]["requests"]]


# ---------------------------------------------------------------------------
# the offline tuner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knobs", [None, ["serving.token_budget"],
                                   ["zero_optimization.reduce_bucket_size",
                                    "zero_optimization.quant_block"]])
def test_offline_tuner_equal_jax(artifact, knobs):
    base = {"train_micro_batch_size_per_gpu": 1}
    got = tat.OfflineTuner(artifact, base_config=base, knobs=knobs).tune()
    want = jat.OfflineTuner(artifact, base_config=base, knobs=knobs).tune()
    assert got == want
    assert got["improved_signals"] >= 1 or knobs is not None
    deltas = [r["delta"] for r in got["report"]]
    assert deltas == sorted(deltas, reverse=True)
    for name, value in got["tuned"].items():
        assert ttun.REGISTRY.get(name).in_range(value), name
    assert tat.serving_overrides(got["config"]) == \
        jat.serving_overrides(got["config"])
    assert tat.serving_overrides({}) == {}


def test_tuned_config_loads_with_provenance(artifact):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.config import check_ported
    result = tat.OfflineTuner(
        artifact, base_config={"train_micro_batch_size_per_gpu": 1}).tune()
    cfg = result["config"]
    assert cfg["autotuning"]["tuned"] == result["tuned"]
    ds = DeepSpeedConfig(cfg)
    check_ported(ds)    # the autotuning block is read, not refused
    for name, value in result["tuned"].items():
        if name.startswith("zero_optimization."):
            assert getattr(ds.cfg.zero_optimization,
                           name.split(".", 1)[1]) == value
        assert ttun.REGISTRY.effective(name) == (value, "tuned"), name
    with pytest.raises(ValueError, match="no offline cost model"):
        tat.OfflineTuner(artifact, knobs=["autoscaler.load_high"])


# ---------------------------------------------------------------------------
# the tunable registry's search half
# ---------------------------------------------------------------------------
def test_tunables_clamp_ladder_effective_equal_jax():
    assert ttun.REGISTRY.names() == jtun.REGISTRY.names()
    assert [t.name for t in ttun.REGISTRY.entries()] == \
        [t.name for t in jtun.REGISTRY.entries()]
    assert {t.name for t in ttun.REGISTRY.entries() if t.online} == \
        {"serving.decode_window", "serving.max_queued_tokens"}
    probes = (-1e30, -5, 0, 0.5, 1, 3, 64, 65, 1 << 20, 1e30)
    for name in ttun.REGISTRY.names():
        assert name in ttun.REGISTRY and name in jtun.REGISTRY
        assert ttun.REGISTRY.ladder(name) == jtun.REGISTRY.ladder(name)
        for v in probes:
            got, want = ttun.clamp(name, v), jtun.clamp(name, v)
            assert (got, type(got)) == (want, type(want)), (name, v)
        assert ttun.REGISTRY.effective(name) == \
            jtun.REGISTRY.effective(name)
        t = ttun.REGISTRY.get(name)
        if t.default is not None:
            assert t.in_range(t.default)
        ttun.observe(name, t.default if t.default is not None else 7,
                     "online")
        jtun.observe(name, t.default if t.default is not None else 7,
                     "online")
        assert ttun.REGISTRY.effective(name) == \
            jtun.REGISTRY.effective(name)
    assert "bogus" not in ttun.REGISTRY
    with pytest.raises(KeyError):
        ttun.REGISTRY.ladder("bogus")
    ttun.REGISTRY.reset_observations()
    assert ttun.REGISTRY.effective("serving.decode_window") == \
        (8, "default")


# ---------------------------------------------------------------------------
# the online adapter
# ---------------------------------------------------------------------------
class StubEngine:
    """The adapter's engine surface, over one package's registry:
    ``set_decode_window`` mirrors the engines' registry check and warmth
    marking."""

    def __init__(self, tun, window=8, warmed=(1, 2, 4, 8)):
        self.tun = tun
        self.decode_window = window
        self.warmed = set(warmed)
        self.moves = []

    def warmed_decode_windows(self):
        return sorted(self.warmed)

    def set_decode_window(self, window, *, source="online"):
        window = self.tun.check("serving.decode_window", window,
                                label="decode_window")
        self.moves.append((self.decode_window, window))
        self.decode_window = window
        self.warmed.add(window)
        self.tun.observe("serving.decode_window", window, source)
        return window


class ScriptedSLO:
    def __init__(self):
        self.burn = False

    def burning(self):
        return self.burn


# (adapter config, engine window, warmed windows, admission budget or
#  "off", steady, pad fraction, burn script)
SCENARIOS = {
    "burn_then_recover": (dict(min_decode_window=2), 8, (1, 2, 4, 8),
                          "off", False, 0.0, [1] * 8 + [0] * 14),
    "hold_and_interval": (dict(hold_ticks=3, interval_s=2.5), 8,
                          (1, 2, 4, 8), "off", False, 0.0,
                          [1] * 12 + [0] * 20),
    "budget_shrinks_and_restores": (dict(restore_ticks=1), 8, (1, 2, 4, 8),
                                    4096, False, 0.0,
                                    [1] * 5 + [0] * 12 + [1] * 2 + [0] * 9),
    "uncapped_budget": (dict(), 16, (2, 4, 16), None, False, 0.0,
                        [1] * 6 + [0] * 30),
    "high_pad_restores_budget_first": (dict(restore_ticks=1), 8,
                                       (1, 2, 4, 8), 8192, False, 0.9,
                                       [1] * 3 + [0] * 12),
    "steady_warmed_only": (dict(min_decode_window=1), 32, (4, 32), "off",
                           True, 0.0, [1] * 6 + [0] * 10),
    "disabled": (dict(enabled=False), 8, (1, 2, 4, 8), 4096, False, 0.0,
                 [1] * 6),
}


def _drive(pkg, scenario):
    at, adm, tun, tel = PKGS[pkg]
    cfg, window, warmed, budget, steady, pad, script = SCENARIOS[scenario]
    cfg = dict(dict(interval_s=0.0, hold_ticks=1, restore_ticks=2), **cfg)
    tel.watchdog.reset()
    tel.watchdog.mark_steady(steady)
    tun.REGISTRY.reset_observations()
    tel.get_registry().gauge("inference_ragged_pad_fraction",
                             "padding waste").set(pad)
    eng = StubEngine(tun, window, warmed)
    admission = (None if budget == "off" else adm.AdmissionController(
        adm.AdmissionConfig(max_queued_tokens=budget)))
    if admission is not None:
        for uid in range(3):   # queued work the uncapped shrink bounds by
            admission.try_admit(types.SimpleNamespace(
                uid=uid, prompt=[1] * 700, max_new_tokens=64,
                tenant="default", weight=None))
    slo = ScriptedSLO()
    clock = {"t": 0.0}
    adapter = at.OnlineAdapter(eng, admission=admission, slo=slo,
                               config=at.OnlineAdapterConfig(**cfg),
                               clock=lambda: clock["t"])
    trace = []
    for burn in script:
        slo.burn = bool(burn)
        clock["t"] += 1.0
        moved = adapter.tick()
        trace.append((moved, eng.decode_window,
                      None if admission is None
                      else admission.config.max_queued_tokens,
                      adapter.armed, adapter.adaptations))
    fam = tel.get_registry().get("autotune_online_adaptations_total")
    counts = {(k, d): fam.labels(knob=k, direction=d).value
              for k in ("decode_window", "max_queued_tokens")
              for d in ("down", "up")}
    events = [(e.get("knob"), e.get("old"), e.get("new"), e.get("reason"))
              for e in tel.get_recorder().events(kind="autotune_adapt")]
    tel.watchdog.reset()
    return trace, eng.moves, counts, events, \
        tun.REGISTRY.effective("serving.decode_window")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_online_adapter_decisions_equal_jax(scenario):
    got, want = _drive("torch", scenario), _drive("jax", scenario)
    assert got == want
    trace, moves, _, events, _ = got
    lo = ttun.REGISTRY.get("serving.decode_window").lo
    for old, new in moves:
        assert new >= lo
        assert new in ttun.REGISTRY.ladder("serving.decode_window") or \
            new in SCENARIOS[scenario][2]
    if scenario == "disabled":
        assert moves == [] and events == []
    elif scenario == "steady_warmed_only":
        assert {new for _, new in moves} <= {4, 32}
    else:
        assert any(e[3] == "slo_burn" for e in events)
        assert trace[-1][3], trace      # re-armed after the recovery


def test_serving_runtime_ticks_the_adapter(monkeypatch):
    """``ServingConfig.autotune`` builds the adapter over the engine, the
    admission controller and the SLO monitor, and the loop ticks it after
    the SLO monitor; streams are the engine's own."""
    models = Models()
    eng = models.torch_engine()
    ref = models.torch_engine().generate([[5, 6, 7, 8] * 3], 6)[0]
    ticks = []

    async def run():
        serving = tserve.ServingEngine(eng, tserve.ServingConfig(
            token_budget=64, chunk=16,
            autotune=tat.OnlineAdapterConfig(interval_s=0.0)))
        adapter = serving.adapter
        assert isinstance(adapter, tat.OnlineAdapter)
        assert adapter.engine is eng and adapter.admission is \
            serving.admission and adapter.slo is serving.diagnostics.slo
        orig = adapter.tick
        monkeypatch.setattr(adapter, "tick",
                            lambda now=None: ticks.append(1) or orig(now))
        await serving.start()
        s = await serving.submit([5, 6, 7, 8] * 3, 6)
        out = await s.drain()
        await serving.stop()
        off = tserve.ServingEngine(eng, tserve.ServingConfig(
            autotune=tat.OnlineAdapterConfig(enabled=False)))
        assert off.adapter is None
        return out

    out = asyncio.run(run())
    assert list(out) == list(ref[12:])
    assert ticks

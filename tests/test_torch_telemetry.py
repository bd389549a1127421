"""PyTorch port: the telemetry tier against the JAX package.

``deepspeed_tpu_torch.telemetry`` copies the JAX package's registry,
flight recorder, W3C trace context, timeline export and anomaly
detectors, and ports ``trace`` (spans mirrored into torch.profiler),
``memory`` (tensor trees and the CUDA caching allocator) and ``watchdog``
(kernel builds and first calls at new shapes). The same operations go
through both packages and give the same documents: the Prometheus text
byte for byte (time-valued samples masked where a sample is one), the
recorder's events and the Chrome-trace JSON with their clock fields
masked, and the same detector verdicts on the same inputs under fake
clocks. Nothing here waits on the wall clock.
"""

import json
import re

import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.ragged.ragged_manager import \
    DSStateManager as JStateManager

from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import \
    DSStateManager
from deepspeed_tpu_torch.telemetry import (memory, postmortem, trace,
                                           watchdog)

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

PKGS = {"jax": jtel, "torch": ttel}


# ---------------------------------------------------------------------------
# registry: the same operations, the same exposition
# ---------------------------------------------------------------------------
def _drive_registry(tel, case):
    reg = tel.MetricsRegistry()
    if case == "counters":
        c = reg.counter("requests_total", "requests seen",
                        labelnames=("route", "code"))
        c.labels(route="/generate", code="200").inc(3)
        c.labels(route="/generate", code="429").inc()
        c.labels(route='/we"ird\\', code="400").inc(2.5)
        reg.counter("plain_total", "no labels").inc(7)
    elif case == "gauges":
        g = reg.gauge("depth", "queue depth", unit="requests")
        g.set(5)
        g.dec(2)
        g.inc(0.25)
        reg.gauge("util", "pool util", labelnames=("pool",)).labels(
            pool="kv").set(1e-7)
        reg.gauge("big", "large").set(3.5e12)
        reg.gauge("tiny", "small").set(-2.5e-9)
    elif case == "histograms":
        h = reg.histogram("ttft_seconds", "submit -> first token", unit="s")
        for v in (0.0004, 0.003, 0.02, 0.02, 0.7, 3.0, 1e3):
            h.observe(v)
        h2 = reg.histogram("step_tokens", "tokens per step",
                           buckets=(1, 2, 4, 8, 16), labelnames=("kind",))
        for v in (1, 3, 3, 9, 40):
            h2.labels(kind="ragged").observe(v)
    elif case == "federated":
        a, b = tel.MetricsRegistry(), tel.MetricsRegistry()
        a.counter("x_total", "x").inc(2)
        b.counter("x_total", "x").inc(5)
        b.gauge("only_b", "b").set(1)
        return tel.render_federated([("r0", a), ("r1", b), ("r2", a)])
    return reg.render_prometheus() + json.dumps(reg.snapshot(),
                                                sort_keys=True)


@pytest.mark.parametrize("case", ["counters", "gauges", "histograms",
                                  "federated"])
def test_registry_exposition_identical(case):
    assert _drive_registry(ttel, case) == _drive_registry(jtel, case)


def test_registry_scalar_items_and_bridge_identical():
    class Monitor:
        enabled = True

        def __init__(self):
            self.events = []

        def write_events(self, events):
            self.events.extend(events)

    out = {}
    for name, tel in PKGS.items():
        reg = tel.MetricsRegistry()
        mon = Monitor()
        bridge = tel.TelemetryBridge(mon, registry=reg, flush_interval=2)
        c = reg.counter("steps_total", "steps")
        h = reg.histogram("lat_seconds", "latency", unit="s")
        for step in range(1, 6):
            c.inc()
            h.observe(0.01 * step)
            bridge.step(step)
        bridge.close()
        out[name] = (reg.scalar_items(), mon.events)
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# recorder, context, timeline
# ---------------------------------------------------------------------------
def _mask(ev):
    return {k: v for k, v in ev.items() if k not in ("t", "wall", "seq")}


def test_flight_recorder_documents_identical():
    out = {}
    for name, tel in PKGS.items():
        rec = tel.FlightRecorder(max_bytes=1200)
        for i in range(20):
            rec.record("decode_window", batch=8, tokens=64 + i,
                       dur_s=0.5, uid=i)
        rec.record("shed", reason="queue_full", depth=3)
        seqs = [e["seq"] for e in rec.events()]
        assert seqs == sorted(seqs)
        out[name] = ([_mask(e) for e in rec.events()],
                     [_mask(e) for e in rec.events(kind="shed")],
                     [_mask(e) for e in rec.events(last=2)], rec.stats())
    assert out["torch"] == out["jax"]
    assert out["torch"][3]["dropped"] > 0       # the byte budget held


def test_trace_context_identical():
    hdr = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    for name, tel in PKGS.items():
        ctx = tel.context.from_headers({"traceparent": hdr,
                                        "baggage": "tenant=a,lane=b"})
        assert ctx.trace_id == "4bf92f3577b34da6a3ce929d0e0e4736"
        assert ctx.to_traceparent() == hdr
        assert ctx.baggage == {"tenant": "a", "lane": "b"}
        child = ctx.child()
        assert child.trace_id == ctx.trace_id
        assert child.span_id != ctx.span_id
        wire = tel.context.from_wire(ctx.to_wire())
        assert wire.to_traceparent() == hdr
        assert tel.context.from_headers({"traceparent": "garbage"}) is None
    # each package parses what the other writes
    t = ttel.context.from_traceparent(
        jtel.context.new_context(tenant="x").to_traceparent())
    j = jtel.context.from_traceparent(
        ttel.context.new_context().to_traceparent())
    assert t is not None and j is not None


def test_timeline_documents_identical():
    spans = [
        {"name": "request", "start": 10.0, "duration_s": 0.5, "depth": 0,
         "id": 1, "parent": None, "track": "loop", "lane": "r0",
         "attrs": {"uid": 3, "trace_id": "abc"}},
        {"name": "ragged_step", "start": 10.1, "duration_s": 0.05,
         "depth": 1, "id": 2, "parent": 1, "track": "loop",
         "attrs": {"uids": [3, 4], "trace_ids": ["abc"]}},
        {"name": "decode_window", "start": 10.2, "duration_s": 0.1,
         "depth": 0, "id": 3, "parent": None, "track": "other",
         "attrs": {"uids": [4]}},
    ]

    def docs(tel):
        doc = tel.timeline.to_chrome_trace(spans)
        for ev in doc["traceEvents"]:
            ev.pop("pid")
        return (doc, tel.timeline.request_spans(3, spans),
                tel.timeline.trace_spans("abc", spans))
    assert docs(ttel) == docs(jtel)


def test_trace_spans_record_and_mirror_into_the_profiler():
    trace.clear()
    trace.enable_profiler_annotations(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.span("decode_window", batch=2):
                with trace.span("inner"):
                    torch.ones(4).sum()
    finally:
        trace.enable_profiler_annotations(False)
    names = {e.key for e in prof.key_averages()}
    assert {"decode_window", "inner"} <= names
    outer, = trace.export("decode_window")
    inner, = trace.export("inner")
    assert inner["parent"] == outer["id"] and inner["depth"] == 1
    assert outer["attrs"] == {"batch": 2}


# ---------------------------------------------------------------------------
# anomaly detectors on fake clocks
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _verdict(v):
    return None if v is None else {k: x for k, x in v.items()
                                   if k not in ("wall", "stacks")}


def test_stall_watchdog_fires_identically():
    out = {}
    for name, tel in PKGS.items():
        clock = FakeClock()
        cfg = tel.DiagnosticsConfig(stall_min_deadline_s=2.0,
                                    stall_factor=4.0)
        wd = tel.anomaly.StallWatchdog(cfg, clock=clock)
        wd.register("serving_loop")
        wd.set_active("serving_loop", True)
        seen = []
        for dt in (1.0, 1.0, 1.0, 1.5, 9.0):
            wd.beat("serving_loop")
            clock.t += dt
            seen.append([_verdict(v) for v in wd.check_now()])
        seen.append(wd.heartbeat_age("serving_loop"))
        wd.set_active("serving_loop", False)
        seen.append(wd.heartbeat_age("serving_loop"))
        out[name] = seen
    assert out["torch"] == out["jax"]
    assert out["torch"][-3][0]["kind"] == "stall"


def test_slo_burn_monitor_fires_identically():
    out = {}
    for name, tel in PKGS.items():
        clock = FakeClock()
        reg = tel.MetricsRegistry()
        cfg = tel.DiagnosticsConfig(slo_min_samples=5, slo_fast_window_s=10,
                                    slo_slow_window_s=60)
        mon = tel.anomaly.SLOBurnRateMonitor(cfg, registry=reg, clock=clock)
        ttft = reg.histogram("serving_ttft_seconds", "ttft", unit="s")
        reg.histogram("serving_tpot_seconds", "tpot", unit="s")
        burns = [mon.tick()]
        for k in range(6):
            clock.t += 2.0
            for _ in range(10):
                ttft.observe(0.1 if k < 2 else 5.0)   # then miss the SLO
            burns.append(mon.tick())
        out[name] = (burns, mon.burning(), mon.quantiles())
    assert out["torch"] == out["jax"]
    assert out["torch"][1]


def test_loss_anomaly_detector_fires_identically():
    out = {}
    for name, tel in PKGS.items():
        det = tel.anomaly.LossAnomalyDetector(
            tel.DiagnosticsConfig(loss_window=16), leaf_names=["a", "b"])
        rng = np.random.default_rng(0)
        verdicts = []
        for step in range(30):
            loss = 2.0 + 0.01 * rng.standard_normal()
            if step == 20:
                loss = 50.0                      # a spike
            if step == 25:
                loss = float("nan")
            verdicts.append(_verdict(det.update(
                step, loss, 1.0, leaf_sqnorms=np.array([1.0, 4.0]))))
        out[name] = verdicts
    # json: the NaN loss in a verdict compares equal as text
    assert json.dumps(out["torch"]) == json.dumps(out["jax"])
    kinds = [v["kind"] for v in out["torch"] if v]
    assert "loss_spike" in kinds and "nan_loss" in kinds


def test_kv_leak_detector_identical():
    sm_kw = dict(max_tracked_sequences=4, max_seq_len=64, num_blocks=17,
                 block_size=8)
    out = {}
    for name, tel, sm in (
            ("jax", jtel, JStateManager(JSM(**sm_kw))),
            ("torch", ttel, DSStateManager(DSStateManagerConfig(**sm_kw)))):
        det = tel.anomaly.KVLeakDetector()
        sm.ensure_blocks(1, 20)
        sm.ensure_blocks(2, 9)
        leak = _verdict(det.check_at_drain(sm, inflight_uids=[1]))
        sm.flush_sequence(1)
        sm.flush_sequence(2)
        clean = det.check_at_drain(sm)
        out[name] = (leak, clean)
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["orphan_uids"] == [2] and out["torch"][1] is None


# ---------------------------------------------------------------------------
# watchdog, memory, post-mortem (the port's own adaptations)
# ---------------------------------------------------------------------------
def test_watchdog_counts_builds_and_new_signatures():
    reg = ttel.get_registry()
    events = reg.get("xla_compile_events_total")
    before = {p: s.value for (p,), s in events.series()} if events else {}

    calls = []
    fn = watchdog.watch("probe_fn", lambda x, cache=None: calls.append(x))
    assert watchdog.watch("probe_fn", fn) is fn
    a, b = torch.zeros(2, 3), torch.zeros(4, 3)
    for x in (a, a, b, a, b, torch.zeros(2, 3, dtype=torch.int32)):
        fn(x, cache={"k": torch.zeros(1)})
    watchdog.record_build("probe_lib", 1.25)

    events = reg.get("xla_compile_events_total")
    after = {p: s.value for (p,), s in events.series()}
    assert after["probe_fn"] - before.get("probe_fn", 0) == 3
    assert after["build:probe_lib"] - before.get("build:probe_lib", 0) == 1
    assert reg.get("xla_compiled_programs").labels(
        program="probe_fn").value == 3
    assert len(calls) == 6
    summary = watchdog.summary()
    assert summary["build:probe_lib"]["seconds"] >= 1.25
    # a new shape after mark_steady is a steady-state recompile
    watchdog.mark_steady(True)
    try:
        fn(torch.zeros(9))
        assert watchdog.summary()["probe_fn"]["steady_state_recompiles"] \
            >= 1
        assert watchdog.events()[-1]["steady_state"]
    finally:
        watchdog.mark_steady(False)


def test_tree_bytes_over_tensors():
    from deepspeed_tpu_torch.inference.quantization import QuantizedTensor
    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5, dtype=torch.int8),
                                         (torch.zeros(2, dtype=torch.bfloat16),
                                          np.zeros(3, np.float64))],
            "q": QuantizedTensor(torch.zeros(4, 8, dtype=torch.int8),
                                 torch.zeros(4, 1), (4, 8), torch.bfloat16),
            "none": None}
    assert memory.tree_bytes(tree) == 48 + 5 + 4 + 24 + 32 + 16
    # the same count as the JAX package's over the same arrays
    arrays = {"a": np.zeros((3, 4), np.float32), "b": np.zeros(5, np.int8)}
    assert memory.tree_bytes({k: torch.from_numpy(v)
                              for k, v in arrays.items()}) == \
        jtel.memory.tree_bytes(arrays)


def test_memory_report_and_postmortem_bundle(tmp_path):
    memory.record_buffer("kv_pool", 1 << 20)
    memory.record_buffer("params", 3 << 20)
    rep = memory.device_memory("cpu")
    assert rep == {"allocated": 0, "peak": 0, "free": 0, "total": 0}
    memory.record_device("cpu")
    oom = memory.oom_report()
    assert oom["largest_buffer"] == "params"
    assert oom["devices"]["cpu"]["total"] == 0
    assert "params" in memory.format_oom_report(oom)
    path = postmortem.write_bundle(
        "test", config=ttel.DiagnosticsConfig(postmortem_dir=str(tmp_path)),
        force=True)
    manifest = json.loads((tmp_path / path.split("/")[-1] /
                           "manifest.json").read_text())
    assert manifest["reason"] == "test"
    fp = json.loads((tmp_path / path.split("/")[-1] /
                     "fingerprint.json").read_text())
    assert fp["torch"] == torch.__version__
    assert re.match(r"\d+\.\d+", fp["python"])


def test_tunables_registry_identical():
    from deepspeed_tpu.runtime import tunables as jt
    from deepspeed_tpu_torch.runtime import tunables as tt
    from deepspeed_tpu.inference.v2 import config_v2 as jcfg
    from deepspeed_tpu_torch.inference.v2 import config_v2 as tcfg
    # the port registers only the knobs its code reads, each as in JAX
    assert tt.REGISTRY.names() == [
        "zero_optimization.reduce_bucket_size",
        "zero_optimization.allgather_bucket_size",
        "zero_optimization.stage3_prefetch_bucket_size",
        "zero_optimization.quant_block",
        "serving.decode_window", "serving.prefill_bucket",
        "serving.max_queued_tokens",
        "state_manager.kv_spill_host_bytes",
        "state_manager.kv_spill_disk_bytes"]
    for name in tt.REGISTRY.names():
        t, j = tt.REGISTRY.get(name), jt.REGISTRY.get(name)
        assert (t.range_str(), t.default, t.kind, t.cost_signal,
                t.online) == (j.range_str(), j.default, j.kind,
                              j.cost_signal, j.online)
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="registered tunable"):
            mod.check("serving.decode_window", 65)
    msgs = []
    for cls in (jcfg.RaggedInferenceEngineConfig,
                tcfg.RaggedInferenceEngineConfig):
        with pytest.raises(ValueError) as e:
            cls(prefill_bucket=0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

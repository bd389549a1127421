"""PyTorch port: the fleet's telemetry over the router (``router.py``'s
``fleet_timeline``, ``federated_metrics`` and fleet post-mortem), the
cases of the JAX package's ``test_distributed_tracing.py``.

* A disaggregated request (greedy and seeded sampled) keeps one trace id
  from router dispatch through prefill, the handoff and decode; the
  stitched fleet timeline has its spans in causal order on one process
  row per lane.
* Replicas with registries of their own federate under a ``replica``
  label in the router's ``/metrics``.
* A replica's anomaly verdict makes one fleet post-mortem bundle (the
  same verdict is not answered twice).
"""

import asyncio
import json

from torch_fleet_common import SERVE, Models, prompts, serving_config

from deepspeed_tpu_torch.telemetry import anomaly as ds_anomaly
from deepspeed_tpu_torch.telemetry import context as trace_context
from deepspeed_tpu_torch.telemetry import get_registry, postmortem, timeline
from deepspeed_tpu_torch.telemetry import trace
from deepspeed_tpu_torch.telemetry.anomaly import DiagnosticsConfig

S = SERVE["torch"]
_ENGINE_SPANS = ("ragged_step", "prefill", "decode_step", "decode_window")


def _first(spans, pred, what):
    xs = [s for s in spans if pred(s)]
    assert xs, (what, [(s["name"], s.get("lane")) for s in spans])
    return min(xs, key=lambda s: s["start"])


def test_disaggregated_request_one_trace_id_causal_order():
    models = Models()
    trace.clear()
    ps = prompts((20, 33), seed=21)
    kws = [dict(), dict(temperature=0.8, top_p=0.9, seed=11)]

    async def run():
        replicas = S.build_replicas(
            [models.torch_engine(), models.torch_engine()],
            serving_config("torch"), own_registries=True)
        router = S.ReplicaRouter(replicas, S.RouterConfig(
            disaggregated=True, monitor_interval_s=0.0),
            prefill_replicas=[S.PrefillReplica("prefill0",
                                               models.torch_engine())])
        await router.start()
        tids, outs = [], []
        for p, kw in zip(ps, kws):
            ctx = trace_context.new_context()
            with trace_context.use(ctx):
                stream = await router.submit(p, 12, **kw)
            outs.append(await stream.drain())
            tids.append(ctx.trace_id)
        metrics = router.federated_metrics()
        await router.stop()
        return tids, outs, metrics

    tids, outs, metrics = asyncio.run(run())
    assert all(len(o) == 12 for o in outs) and tids[0] != tids[1]
    for tid in tids:
        spans = timeline.trace_spans(tid)
        dispatch = _first(spans, lambda s: s["name"] == "router_dispatch",
                          "dispatch")
        assert dispatch.get("lane") == "router"
        assert dispatch["attrs"]["prefill_replica"] == "prefill0"
        prefill = _first(spans, lambda s: (s.get("lane") == "prefill0" and
                                           s["name"] in _ENGINE_SPANS),
                         "prefill")
        handoff = _first(spans, lambda s: s["name"] == "router_handoff",
                         "handoff")
        assert handoff["attrs"]["src"] == "prefill0"
        decode = _first(spans, lambda s: (
            str(s.get("lane", "")).startswith("replica")
            and s["name"] in _ENGINE_SPANS), "decode")
        assert (dispatch["start"] <= prefill["start"] <= handoff["start"]
                <= decode["start"])
        obj = timeline.stitch_fleet(trace_id=tid)
        rows = {e["args"]["name"] for e in obj["traceEvents"]
                if e["ph"] == "M" and e["name"] == "process_name"}
        assert {"router", "prefill0"} <= rows
        assert any(r.startswith("replica") for r in rows)
        json.loads(json.dumps(obj))
    assert not ({s["id"] for s in timeline.trace_spans(tids[0])}
                & {s["id"] for s in timeline.trace_spans(tids[1])})
    assert 'replica="replica0"' in metrics
    assert 'replica="replica1"' in metrics


def test_replica_anomaly_triggers_one_fleet_bundle(tmp_path):
    models = Models()
    postmortem._reset_for_tests()
    ds_anomaly.reset()

    async def run():
        diag = DiagnosticsConfig(postmortem_on_anomaly=True,
                                 postmortem_dir=str(tmp_path))
        replicas = S.build_replicas([models.torch_engine()],
                                    serving_config("torch"))
        router = S.ReplicaRouter(replicas, S.RouterConfig(
            monitor_interval_s=0.0, diagnostics=diag))
        await router.start()
        reg = get_registry()
        b0 = reg.family_total("router_fleet_postmortems_total")
        await router._maybe_fleet_postmortem()
        assert not list(tmp_path.glob("fleet-*"))
        ds_anomaly.report("stall", "replica0 wedged mid-step")
        await router._maybe_fleet_postmortem()
        bundles = list(tmp_path.glob("fleet-*"))
        assert len(bundles) == 1 and "stall" in bundles[0].name
        manifest = json.loads((bundles[0] / "manifest.json").read_text())
        assert manifest["kind"] == "fleet"
        assert "replica0" in manifest["replicas"]
        assert router.router_statusz()["last_fleet_bundle"] == \
            str(bundles[0])
        await router._maybe_fleet_postmortem()     # answered once
        assert len(list(tmp_path.glob("fleet-*"))) == 1
        assert reg.family_total("router_fleet_postmortems_total") - b0 == 1
        await router.stop()

    try:
        asyncio.run(run())
    finally:
        postmortem._reset_for_tests()
        ds_anomaly.reset()

"""Offline profile-guided tuning.

Port of ``deepspeed_tpu/autotuning/offline.py``, a copy. Replays a
captured workload artifact (capture.py) through DEVICE-FREE cost models of
the registered tunables and searches the registry's knob space by
coordinate descent with early pruning. Nothing here touches a device: the
train-side knobs are scored on the planners the runtime executes
(``runtime/grad_overlap.build_bucket_plan`` / ``ring_wire_bytes``,
``runtime/offload.plan_prefetch_buckets``, fed a proxy parameter set),
and the serving-side knobs on structural math over the replayed request
mix (window tail waste, bucket padding, the shared queueing model in
``capture.simulate_queue``).

Each knob's cost function is a proxy for its registered ``cost_signal``
(runtime/tunables.py): the report ranks knobs by cost delta against the
registry defaults, and ``improved_signals`` counts the distinct cost
signals the tuned values improved.

The tuned output is a runtime config dict that ``DeepSpeedConfig``
accepts verbatim: train knobs land in their native blocks
(``zero_optimization.*``), serving knobs under ``autotuning.serving``
(read back via :func:`serving_overrides`), and every moved knob is
stamped under ``autotuning.tuned`` so config loading records provenance
``tuned`` for /statusz."""

import copy
import math
from typing import Callable, Dict, List, Optional

from ..runtime import tunables
from .capture import replay_schedule, simulate_queue

_EPS = 1e-9
# per-bucket launch overhead in cost units: collective dispatch is not
# free, so the bucket-size evaluators charge a small constant per bucket
# (otherwise "as many tiny buckets as possible" always wins)
_LAUNCH_COST = 0.01
_PROGRAM_COST = 0.02     # per distinct compiled prefill bucket shape


def _proxy_param_units():
    """A transformer-shaped proxy parameter set for the bucket
    planners: embed + head replicated (all-reduce), stacked layer
    leaves dim-sharded (reduce-scatter) — the flagship-fit geometry
    aot_scale uses, small enough to plan in microseconds."""
    from ..runtime.grad_overlap import (ALL_REDUCE, REDUCE_SCATTER,
                                        order_units)
    V, H, L = 32_000, 1024, 8
    names = ["embed", "layers.attn", "layers.mlp", "head"]
    numels = [V * H, L * 4 * H * H, L * 8 * H * H, V * H]
    kinds = [ALL_REDUCE, REDUCE_SCATTER, REDUCE_SCATTER, ALL_REDUCE]
    layers = [0, L, L, 0]
    stacked = [False, True, True, False]
    return order_units(names, numels, kinds, layers, stacked)


class OfflineTuner:
    """Coordinate descent over the tunable registry against a replayed
    workload. ``knobs`` defaults to every registry entry this tuner has
    a cost model for; ``base_config`` is the runtime config dict the
    tuned values merge into."""

    def __init__(self, artifact: Dict,
                 base_config: Optional[Dict] = None,
                 knobs: Optional[List[str]] = None,
                 registry: tunables.TunableRegistry = tunables.REGISTRY,
                 passes: int = 2, dp: int = 8,
                 step_time_s: float = 0.02):
        self.artifact = artifact
        self.base_config = base_config or {}
        self.registry = registry
        self.passes = max(int(passes), 1)
        self.dp = max(int(dp), 2)
        self.step_time_s = float(step_time_s)
        self.schedule = replay_schedule(artifact)
        self._units = None
        self._evals: Dict[str, Callable] = {
            "zero_optimization.reduce_bucket_size": self._cost_buckets,
            "zero_optimization.allgather_bucket_size": self._cost_buckets,
            "zero_optimization.stage3_prefetch_bucket_size":
                self._cost_prefetch,
            "zero_optimization.quant_block": self._cost_quant_block,
            "serving.decode_window": self._cost_decode_window,
            "serving.prefill_bucket": self._cost_prefill_bucket,
            "serving.token_budget": self._cost_token_budget,
            "serving.max_queued_tokens": self._cost_queued_tokens,
        }
        if knobs is None:
            knobs = [n for n in registry.names() if n in self._evals]
        unknown = [k for k in knobs if k not in self._evals]
        if unknown:
            raise ValueError(
                f"no offline cost model for tunables {unknown} — "
                f"searchable: {sorted(self._evals)}")
        self.knobs = knobs
        self.trials = 0

    # -- cost models (device-free proxies for each cost_signal) --------
    def _plan(self, reduce_bs: int, allgather_bs: int):
        from ..runtime.grad_overlap import build_bucket_plan
        if self._units is None:
            self._units = _proxy_param_units()
        return build_bucket_plan(self._units, reduce_bs, allgather_bs)

    def _cost_buckets(self, value: int, cur: Dict) -> float:
        """Proxy for train_grad_exposed_collective_fraction: the final
        bucket's collective cannot hide behind remaining backward
        compute, so its share of the total is the exposed tail; each
        extra bucket pays a launch."""
        if "reduce_bucket_size" in cur["_knob"]:
            plan = self._plan(value,
                              cur["zero_optimization.allgather_bucket_size"])
        else:
            plan = self._plan(cur["zero_optimization.reduce_bucket_size"],
                              value)
        ring = [b for b in plan.buckets
                if b.kind in ("reduce_scatter", "all_reduce")]
        if not ring:
            return 1.0
        total = sum(b.numel for b in ring)
        exposed = ring[-1].numel / max(total, 1)
        return exposed + _LAUNCH_COST * len(ring)

    def _cost_prefetch(self, value: int, cur: Dict) -> float:
        """Proxy for offload_prefetch_hit_fraction: the stream's first
        bucket is fetched with nothing to overlap behind (a miss by
        construction), so its share of the total is the exposed
        fraction; each extra bucket pays a dispatch."""
        from ..runtime.offload import plan_prefetch_buckets
        if self._units is None:
            self._units = _proxy_param_units()
        numels = [u.numel for u in self._units]
        buckets = plan_prefetch_buckets(numels, int(value))
        total = sum(numels)
        first = sum(numels[i] for i in buckets[0])
        return first / max(total, 1) + _LAUNCH_COST * len(buckets)

    def _cost_quant_block(self, value: int, cur: Dict) -> float:
        """Proxy for train_quant_reduce_wire_ratio: quantized vs fp32
        ring bytes on the proxy plan (pure host arithmetic —
        grad_overlap.ring_wire_bytes)."""
        from ..runtime.grad_overlap import ring_wire_bytes
        plan = self._plan(cur["zero_optimization.reduce_bucket_size"],
                          cur["zero_optimization.allgather_bucket_size"])
        fp32 = ring_wire_bytes(plan, self.dp, quantized=False)
        quant = ring_wire_bytes(plan, self.dp, quantized=True,
                                quant_block=int(value))
        return quant / max(fp32, 1)

    def _cost_decode_window(self, value: int, cur: Dict) -> float:
        """Proxy for inference_decode_host_syncs_total: host syncs per
        generated token (one per window) plus the device steps the last
        window wastes past each request's tail."""
        K = max(int(value), 1)
        syncs = waste = 0.0
        for req in self.schedule:
            L = max(req["new_tokens"], 1)
            windows = math.ceil(L / K)
            syncs += windows / L
            waste += (windows * K - L) / (windows * K)
        n = len(self.schedule)
        return syncs / n + waste / n

    def _cost_prefill_bucket(self, value: int, cur: Dict) -> float:
        """Proxy for inference_ragged_pad_fraction: padding waste of
        the recorded prompt mix against this bucket granularity, plus a
        charge per distinct compiled bucket shape."""
        B = max(int(value), 1)
        pad = 0.0
        shapes = set()
        for req in self.schedule:
            L = max(req["prompt_len"], 1)
            padded = math.ceil(L / B) * B
            pad += 1.0 - L / padded
            shapes.add(padded)
        return pad / len(self.schedule) + _PROGRAM_COST * len(shapes)

    def _cost_token_budget(self, value: int, cur: Dict) -> float:
        """Proxy pairing inference_ragged_pad_fraction with queueing
        delay: a small step budget leaves work waiting, a large one
        pads out unfilled steps."""
        sim = simulate_queue(self.schedule, int(value),
                             step_time_s=self.step_time_s)
        return 10.0 * sim["mean_wait_s"] + sim["pad_fraction"]

    def _cost_queued_tokens(self, value: int, cur: Dict) -> float:
        """Proxy for serving_admission_queued_tokens: shed work is the
        dominant cost, queued-but-waiting work the secondary one."""
        sim = simulate_queue(self.schedule,
                             cur["serving.token_budget"],
                             step_time_s=self.step_time_s,
                             max_queued_tokens=int(value))
        return 4.0 * sim["shed_fraction"] + sim["p95_wait_s"]

    # -- search --------------------------------------------------------
    def _eval(self, knob: str, value, cur: Dict) -> float:
        self.trials += 1
        cur = dict(cur, _knob=knob)
        return float(self._evals[knob](value, cur))

    def _descend(self, knob: str, cur: Dict):
        """One coordinate: walk the ladder outward from the current
        value in both directions, pruning a direction after two
        consecutive non-improving candidates (the ladder costs are
        near-unimodal, so the tail cannot win)."""
        ladder = self.registry.ladder(knob)
        start = cur[knob]
        if start not in ladder:
            ladder = sorted(set(ladder) | {start})
        pos = ladder.index(start)
        best, best_cost = start, self._eval(knob, start, cur)
        for step in (1, -1):
            misses = 0
            i = pos + step
            while 0 <= i < len(ladder) and misses < 2:
                cost = self._eval(knob, ladder[i], cur)
                if cost < best_cost - _EPS:
                    best, best_cost = ladder[i], cost
                    misses = 0
                else:
                    misses += 1
                i += step
        return best, best_cost

    def tune(self) -> Dict:
        cur: Dict = {}
        for name in self._evals:
            t = self.registry.get(name)
            if t.default is not None:
                cur[name] = t.kind(t.default)
            else:
                cur[name] = self.registry.ladder(name)[-1]
        baseline = {k: self._eval(k, cur[k], cur) for k in self.knobs}
        for _ in range(self.passes):
            moved = False
            for knob in self.knobs:
                best, _cost = self._descend(knob, cur)
                if best != cur[knob]:
                    cur[knob] = best
                    moved = True
            if not moved:
                break
        report = []
        improved = set()
        for knob in self.knobs:
            t = self.registry.get(knob)
            tuned_cost = self._eval(knob, cur[knob], cur)
            delta = baseline[knob] - tuned_cost
            if delta > _EPS:
                improved.add(t.cost_signal)
            report.append({
                "knob": knob,
                "cost_signal": t.cost_signal,
                "default": t.default,
                "tuned": cur[knob],
                "baseline_cost": round(baseline[knob], 6),
                "tuned_cost": round(tuned_cost, 6),
                "delta": round(delta, 6),
            })
        report.sort(key=lambda r: -r["delta"])
        tuned = {k: cur[k] for k in self.knobs
                 if cur[k] != self.registry.get(k).default}
        return {
            "tuned": tuned,
            "report": report,
            "improved_signals": len(improved),
            "trials": self.trials,
            "config": self.to_config(tuned),
        }

    def to_config(self, tuned: Dict) -> Dict:
        """Merge tuned values into ``base_config`` as a dict
        ``DeepSpeedConfig`` accepts: ``zero_optimization.*`` natively,
        serving knobs under ``autotuning.serving``, and everything
        stamped under ``autotuning.tuned`` (provenance)."""
        cfg = copy.deepcopy(self.base_config)
        at = cfg.setdefault("autotuning", {})
        at["tuned"] = dict(tuned)
        for name, value in tuned.items():
            block, _, key = name.partition(".")
            if block == "zero_optimization":
                cfg.setdefault("zero_optimization", {})[key] = value
            else:
                at.setdefault(block, {})[key] = value
        return cfg


def serving_overrides(config: Dict) -> Dict:
    """Extract the tuned serving-side knobs from a tuned config dict
    (the ``autotuning.serving`` block) as kwargs for the serving stack:
    ``decode_window``/``prefill_bucket`` belong on
    ``RaggedInferenceEngineConfig``, ``token_budget`` on
    ``ServingConfig``, ``max_queued_tokens`` on ``AdmissionConfig``."""
    return dict((config.get("autotuning") or {}).get("serving") or {})

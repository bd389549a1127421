"""Workload capture & replay.

Port of ``deepspeed_tpu/autotuning/capture.py``, a copy. A tuning
decision is only as good as the workload it was scored on, so the tuner
never consumes live traffic directly: it consumes a workload ARTIFACT — a
small, versioned, JSON-serializable description of request arrivals, the
prompt/new-token length mix, and (for training) the gradient bucket
shapes. Three ways to get one:

  * :func:`synthesize` — a load_bench-style open-loop trace (bimodal
    prompt lengths, Poisson arrivals), fully seeded and deterministic,
  * :func:`capture_from_recorder` — serialize the flight-recorder ring
    of a live serving process (``request_submit`` events carry arrival
    time / prompt tokens / max_new_tokens),
  * :func:`save` / :func:`load` — persist/restore the artifact.

:func:`replay_schedule` expands an artifact into the concrete, ordered
replay schedule (arrival-sorted, with deterministic synthetic prompt
token ids). Same artifact in, identical schedule out — byte for byte,
and the same as the JAX package's (tests/test_torch_autotuning.py).

:func:`simulate_queue` is the shared device-free queueing model the
offline tuner scores scheduler/admission knobs with: fixed-token-rate
service over the replayed arrivals, reporting wait quantiles, padding
waste against the step token budget, and shed fraction against the
admission budget.
"""

import json
from typing import Dict, List, Optional

import numpy as np

ARTIFACT_VERSION = 1


def synthesize(requests: int = 64, rate: float = 32.0, seed: int = 0,
               short: tuple = (16, 64), long: tuple = (192, 512),
               long_frac: float = 0.25,
               new_tokens: tuple = (8, 64),
               tenants: tuple = ("default",)) -> Dict:
    """A load_bench-shaped open-loop workload: bimodal prompt lengths
    (chat-style short turns + document-style long prompts) and Poisson
    arrivals at ``rate`` req/s. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(requests)
    prompts = np.where(rng.random(n) < (1.0 - long_frac),
                       rng.integers(short[0], short[1], n),
                       rng.integers(long[0], long[1], n))
    news = rng.integers(new_tokens[0], new_tokens[1], n)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n))
    reqs = [{"t": round(float(arrivals[i]), 6),
             "prompt_len": int(prompts[i]),
             "new_tokens": int(news[i]),
             "tenant": tenants[i % len(tenants)]}
            for i in range(n)]
    return {"version": ARTIFACT_VERSION, "kind": "serving", "seed": int(seed),
            "requests": reqs,
            "meta": {"source": "synthesize", "rate": float(rate)}}


def capture_from_recorder(recorder=None, seed: int = 0) -> Dict:
    """Serialize a live flight-recorder ring into a workload artifact.

    ``request_submit`` events carry everything the replay needs (arrival
    ``t`` on the recorder's perf_counter clock, ``prompt_tokens``,
    ``max_new_tokens``); ``train_step``/``xla_compile`` events
    contribute observed train bucket shapes when present. Raises
    ``ValueError`` on an empty ring — an artifact with no requests
    cannot drive a replay."""
    if recorder is None:
        from ..telemetry.recorder import get_recorder
        recorder = get_recorder()
    submits = recorder.events(kind="request_submit")
    if not submits:
        raise ValueError(
            "flight recorder holds no request_submit events — nothing "
            "to capture (run traffic first, or synthesize a workload)")
    t0 = min(ev["t"] for ev in submits)
    reqs = [{"t": round(float(ev["t"] - t0), 6),
             "prompt_len": int(ev.get("prompt_tokens", 1)),
             "new_tokens": int(ev.get("max_new_tokens", 1)),
             "tenant": str(ev.get("tenant", "default"))}
            for ev in sorted(submits, key=lambda ev: ev["t"])]
    art = {"version": ARTIFACT_VERSION, "kind": "serving",
           "seed": int(seed), "requests": reqs,
           "meta": {"source": "flight_recorder",
                    "events": len(submits)}}
    shapes = sorted({int(ev["tokens"])
                     for ev in recorder.events(kind="train_bucket")
                     if "tokens" in ev})
    if shapes:
        art["train"] = {"bucket_shapes": shapes}
    return art


def save(artifact: Dict, path: str) -> str:
    with open(path, "w") as fh:
        json.dump(artifact, fh, indent=2, sort_keys=True)
    return path


def load(path: str) -> Dict:
    with open(path) as fh:
        art = json.load(fh)
    if art.get("version") != ARTIFACT_VERSION:
        raise ValueError(
            f"workload artifact version {art.get('version')!r} not "
            f"supported (expected {ARTIFACT_VERSION})")
    if not art.get("requests"):
        raise ValueError("workload artifact holds no requests")
    return art


def replay_schedule(artifact: Dict, vocab: int = 1 << 14) -> List[Dict]:
    """Expand an artifact into the deterministic replay schedule:
    arrival-ordered entries with concrete prompt token ids. The ids
    derive from ``(artifact seed, request index)`` alone, so the same
    artifact always yields the identical schedule — replays are
    reproducible across processes and machines."""
    out = []
    order = sorted(range(len(artifact["requests"])),
                   key=lambda i: (artifact["requests"][i]["t"], i))
    for uid, i in enumerate(order):
        req = artifact["requests"][i]
        rng = np.random.default_rng((int(artifact.get("seed", 0)), i))
        out.append({
            "uid": uid,
            "t": float(req["t"]),
            "prompt_len": int(req["prompt_len"]),
            "new_tokens": int(req["new_tokens"]),
            "tenant": req.get("tenant", "default"),
            "prompt": [int(x) for x in
                       rng.integers(1, vocab, int(req["prompt_len"]))],
        })
    return out


def simulate_queue(schedule: List[Dict], token_budget: int,
                   step_time_s: float = 0.02,
                   max_queued_tokens: Optional[int] = None) -> Dict:
    """Chip-free discrete-time queueing model over a replay schedule.

    Service: one scheduler step every ``step_time_s`` consumes up to
    ``token_budget`` tokens of queued work (prompt + new tokens,
    admission's request-cost currency, FIFO). Admission: a request
    arriving when queued work exceeds ``max_queued_tokens`` is shed.
    Reports mean/p95 admission-to-first-service wait, the fraction of
    step capacity left unfilled (padding waste the static bucket pays),
    and the shed fraction."""
    if not schedule:
        raise ValueError("empty replay schedule")
    budget = max(int(token_budget), 1)
    queue: List[List[float]] = []   # [remaining_tokens, arrival_t]
    waits: List[float] = []
    shed = 0
    queued_tokens = 0
    fill_used = 0
    fill_capacity = 0
    pending = sorted(schedule, key=lambda r: (r["t"], r["uid"]))
    idx, n = 0, len(pending)
    t = 0.0
    while idx < n or queue:
        while idx < n and pending[idx]["t"] <= t:
            req = pending[idx]
            cost = req["prompt_len"] + max(req["new_tokens"], 1)
            if (max_queued_tokens is not None
                    and queued_tokens + cost > max_queued_tokens):
                shed += 1
            else:
                queue.append([float(cost), req["t"]])
                queued_tokens += cost
            idx += 1
        if not queue:
            # idle-skip to the next arrival instead of stepping empty
            t = max(t + step_time_s, pending[idx]["t"])
            continue
        room = budget
        while queue and room > 0:
            head = queue[0]
            if head[1] is not None:       # first service for this req
                waits.append(max(t - head[1], 0.0))
                head[1] = None
            take = min(room, head[0])
            head[0] -= take
            room -= take
            queued_tokens -= take
            if head[0] <= 0:
                queue.pop(0)
        fill_used += budget - room
        fill_capacity += budget
        t += step_time_s
    waits_a = np.asarray(waits) if waits else np.zeros(1)
    return {
        "mean_wait_s": float(waits_a.mean()),
        "p95_wait_s": float(np.percentile(waits_a, 95)),
        "pad_fraction": float(1.0 - fill_used / max(fill_capacity, 1)),
        "shed_fraction": float(shed / n),
        "served": int(n - shed),
    }

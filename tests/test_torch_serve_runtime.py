"""PyTorch port: the single-replica serving runtime against the JAX package.

``deepspeed_tpu_torch.inference.v2.serve`` (``ServingEngine``, admission,
the continuous-batching loop, ``ServingAPI``) and the JAX package's
``deepspeed_tpu.inference.v2.serve`` serve the same tiny model on the
same weights (initialized by the JAX package, moved by name through
``checkpoint.interop.params_from_numpy``) in fp32 on the CPU. Held equal:

* greedy streams, and seeded sampled streams through the scheduler path
  (both packages draw on the host with ``host_sample`` and a per-request
  numpy Generator): token-identical;
* HTTP ``/generate`` NDJSON streams and in-process streams;
* the request at which admission sheds (``OverloadedError`` / 429);
* with ``enable_prefix_caching``: streams, the number of digests in the
  prefix index, and the prefix-cache counters.

Deadlines run on an injected clock that advances by itself on every
read, never on the wall clock. HTTP servers bind 127.0.0.1 on port 0.
"""

import asyncio
import dataclasses
import json
import threading

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.scheduler import \
    DynamicSplitFuseScheduler as JSched
from deepspeed_tpu.inference.v2 import serve as jserve
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models.transformer import tiny_test as jax_tiny_test
from deepspeed_tpu.telemetry import get_registry as jax_registry

from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (DynamicSplitFuseScheduler,
                                              InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import serve as tserve
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.telemetry import get_registry as port_registry

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

SM = dict(max_tracked_sequences=8, max_seq_len=256, num_blocks=65,
          block_size=16, max_ragged_batch_size=512)
LENS = (33, 9, 70, 17, 5, 41, 12, 25)
SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=20)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_tiny_test(), num_kv_heads=2)
    jmodel = JModel(jcfg)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    return jmodel, np_params, tmodel, params_from_numpy(np_params)


def _jax_engine(models, **sm_kw):
    jmodel, np_params, _, _ = models
    return JEngine(jmodel, JConfig(state_manager=JSM(**dict(SM, **sm_kw)),
                                   dtype="float32", prefill_bucket=16),
                   params=np_params)


def _torch_engine(models, **sm_kw):
    _, _, tmodel, tparams = models
    return InferenceEngineV2(
        tmodel, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(**dict(SM, **sm_kw)),
            dtype="float32", prefill_bucket=16),
        params=tparams, device="cpu")


@pytest.fixture(scope="module")
def engines(models):
    """One engine per package, shared by the tests of this file (every
    request flushes its blocks, so the pools start each test empty)."""
    return {"jax": (_jax_engine(models), jserve),
            "torch": (_torch_engine(models), tserve)}


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 127, n))) for n in lens]


def _kw(i):
    """Rows 0-3 greedy, rows 4-7 sampled with seeds 1-4."""
    return {} if i < 4 else dict(SAMPLED, seed=i - 3)


async def _serve_in_process(eng, serve, prompts, new, **cfg):
    serving = serve.ServingEngine(eng, serve.ServingConfig(**cfg))
    await serving.start()

    async def one(i):
        stream = await serving.submit(prompts[i], new, **_kw(i))
        return await stream.drain()

    outs = await asyncio.gather(*[one(i) for i in range(len(prompts))])
    await serving.stop(drain=True)
    return outs


async def _http(host, port, method, target, payload=None, headers=None):
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode() if payload is not None else b""
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write((f"{method} {target} HTTP/1.1\r\nHost: t\r\n{extra}"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode().splitlines()
    hdrs = {ln.split(":", 1)[0].strip().lower(): ln.split(":", 1)[1].strip()
            for ln in lines[1:] if ":" in ln}
    return int(lines[0].split()[1]), hdrs, rest


def _counter(text, name):
    """Sum of a family's samples in Prometheus text."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith("#"):
            key = line.split()[0]
            if key == name or key.startswith(name + "{"):
                total += float(line.split()[-1])
    return total


# ---------------------------------------------------------------------------
# streams: in-process and scheduler paths against the JAX package
# ---------------------------------------------------------------------------
def test_serving_streams_match_jax(engines):
    """8 concurrent in-process streams (4 greedy, 4 seeded sampled):
    token-identical across the packages, and the greedy ones equal to the
    port's generate()."""
    prompts = _prompts()
    outs = {name: asyncio.run(_serve_in_process(eng, serve, prompts, 8,
                                                token_budget=48, chunk=16))
            for name, (eng, serve) in engines.items()}
    assert outs["torch"] == outs["jax"]
    ref = engines["torch"][0].generate(prompts[:4], max_new_tokens=8)
    for i in range(4):
        assert prompts[i] + outs["torch"][i] == ref[i].tolist()
    for i, toks in enumerate(outs["torch"]):
        assert len(toks) == 8 and all(0 <= t < 256 for t in toks)


def test_scheduler_sampled_streams_match_jax(engines):
    """The direct scheduler path with every request sampled: each draws
    from its own numpy Generator on the host (host_sample), so seeded
    streams are the JAX package's token for token."""
    prompts = _prompts(seed=5)
    res = {}
    for name, sched_cls in (("jax", JSched),
                            ("torch", DynamicSplitFuseScheduler)):
        sched = sched_cls(engines[name][0], token_budget=48, chunk=16)
        for i, p in enumerate(prompts):
            sched.submit(i, p, 10, temperature=0.7, top_p=0.85, top_k=30,
                         seed=100 + i)
        sched.run()
        res[name] = {u: a.tolist() for u, a in sched.results().items()}
        for u in res[name]:
            sched.release(u)
    assert res["torch"] == res["jax"]


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------
def test_http_generate_equals_in_process_and_routes_work(engines):
    eng, serve = engines["torch"]
    prompts = _prompts(seed=2)
    in_proc = asyncio.run(_serve_in_process(eng, serve, prompts, 8,
                                            token_budget=48, chunk=16))
    reg = port_registry()

    async def main():
        serving = serve.ServingEngine(eng, serve.ServingConfig(
            token_budget=48, chunk=16))
        await serving.start()
        api = serve.ServingAPI(serving)
        host, port = await api.start()
        _, _, m0 = await _http(host, port, "GET", "/metrics")

        async def gen(i):
            payload = dict({"prompt": prompts[i], "max_new_tokens": 8},
                           **_kw(i))
            return await _http(host, port, "POST", "/generate", payload)

        res = await asyncio.gather(*[gen(i) for i in range(len(prompts))])
        routes = {t: await _http(host, port, "GET", t)
                  for t in ("/healthz", "/statusz", "/metrics",
                            "/debug/timeline", "/nope")}
        await api.stop()
        await serving.stop(drain=True)
        return m0.decode(), res, routes

    m0, res, routes = asyncio.run(main())
    streamed = 0
    for i, (status, hdrs, body) in enumerate(res):
        assert status == 200
        assert hdrs["content-type"] == "application/x-ndjson"
        assert "traceparent" in hdrs and hdrs["x-ds-tpu-uid"]
        lines = [json.loads(ln) for ln in body.strip().split(b"\n")]
        tail = lines[-1]
        per_tok = [ln["token"] for ln in lines[:-1]]
        assert tail["done"] and tail["status"] == "completed"
        assert per_tok == tail["tokens"] == in_proc[i]
        assert tail["n"] == 8 and tail["trace_id"]
        streamed += tail["n"]
    status, _, health = routes["/healthz"]
    assert status == 200 and json.loads(health)["status"] == "ok"
    status, _, statusz = routes["/statusz"]
    doc = json.loads(statusz)
    assert status == 200
    assert {"health", "compile", "memory", "recorder", "anomalies",
            "tunables", "slo"} <= set(doc)
    assert doc["compile"]["programs"]["ragged_step"]["compiles"] >= 1
    assert routes["/debug/timeline"][0] == 200
    assert "traceEvents" in json.loads(routes["/debug/timeline"][2])
    assert routes["/nope"][0] == 404
    status, hdrs, metrics = routes["/metrics"]
    assert status == 200 and hdrs["content-type"].startswith("text/plain")
    text = metrics.decode()
    # the counters equal what was streamed
    for name, want in (("serving_requests_submitted_total", 8),
                       ("serving_requests_finished_total", 8),
                       ("serving_generated_tokens_total", streamed)):
        assert _counter(text, name) - _counter(m0, name) == want, name
    assert reg.get("serving_ttft_seconds") is not None
    # every serving / inference family the port exposes is one the JAX
    # package names the same way (same metric, type and labels); building
    # the JAX runtime registers its families
    jserving = jserve.ServingEngine(engines["jax"][0], jserve.ServingConfig())
    jserve.ServingAPI(jserving)
    asyncio.run(jserving.stop(drain=True))
    jfams = {f.name: f for f in jax_registry().families()}
    tfams = [f for f in reg.families()
             if f.name.startswith(("serving_", "inference_", "xla_"))]
    assert len(tfams) > 20
    missing = [f.name for f in tfams if f.name not in jfams]
    assert not missing
    for f in tfams:
        j = jfams[f.name]
        assert (f.kind, f.labelnames) == (j.kind, j.labelnames), f.name


def test_http_bad_requests_and_postmortem(engines, tmp_path):
    eng, serve = engines["torch"]
    from deepspeed_tpu_torch.telemetry import DiagnosticsConfig

    async def main():
        serving = serve.ServingEngine(eng, serve.ServingConfig(
            diagnostics=DiagnosticsConfig(postmortem_dir=str(tmp_path))))
        await serving.start()
        api = serve.ServingAPI(serving)
        host, port = await api.start()
        out = [(await _http(host, port, "POST", "/generate",
                            {"nope": 1}))[0],
               (await _http(host, port, "POST", "/generate",
                            {"prompt": [1], "temperature": "hot"}))[0],
               (await _http(host, port, "GET", "/statusz?format=xml"))[0]]
        pm = await _http(host, port, "POST", "/debug/postmortem")
        await api.stop()
        await serving.stop(drain=True)
        return out, pm

    out, (status, _, body) = asyncio.run(main())
    assert out == [400, 400, 400]
    assert status == 200
    doc = json.loads(body)
    assert doc["path"].startswith(str(tmp_path))
    assert {"metrics", "timeline", "memory", "fingerprint", "recorder",
            "anomalies"} <= set(doc["manifest"]["files"])


# ---------------------------------------------------------------------------
# cancellation, deadlines, overload, drain
# ---------------------------------------------------------------------------
def test_cancel_frees_kv_blocks(engines):
    eng, serve = engines["torch"]
    free0 = eng.state_manager.free_blocks()
    cancelled = port_registry().get("serving_requests_cancelled_total")

    async def main():
        serving = serve.ServingEngine(eng, serve.ServingConfig(
            token_budget=48))
        await serving.start()
        stream = await serving.submit(_prompts((20,))[0], 100)
        got = []
        async for tok in stream:
            got.append(tok)
            if len(got) == 8:
                await stream.cancel()
        await serving.stop(drain=True)
        return stream, got

    c0 = cancelled.value if cancelled is not None else 0
    stream, got = asyncio.run(main())
    assert stream.status == "cancelled"
    assert 8 <= len(got) < 100 and stream.tokens == got
    assert port_registry().get("serving_requests_cancelled_total").value \
        == c0 + 1
    assert eng.state_manager.free_blocks() == free0


class TickClock:
    """A clock that advances ``step`` seconds on every read: deadlines
    expire after a fixed number of the loop's own clock reads, whatever
    the wall clock does."""

    def __init__(self, step=1.0):
        self.t, self.step = 0.0, step
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            self.t += self.step
            return self.t


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_deadline_on_a_fake_clock(engines, pkg):
    """A deadline under the injected clock ends the stream with
    DeadlineExceeded mid-decode, releases the KV blocks and counts one
    expiry."""
    eng, serve = engines[pkg]
    reg = port_registry() if pkg == "torch" else jax_registry()
    free0 = eng.state_manager.free_blocks()

    async def main():
        serving = serve.ServingEngine(
            eng, serve.ServingConfig(token_budget=48), clock=TickClock())
        await serving.start()
        stream = await serving.submit(_prompts((20,))[0], 100,
                                      deadline_s=40.0)
        with pytest.raises(serve.DeadlineExceeded):
            async for _ in stream:
                pass
        await serving.stop(drain=True)
        return stream

    expired = reg.get("serving_deadline_expired_total")
    e0 = expired.value if expired is not None else 0
    stream = asyncio.run(main())
    assert stream.status == "expired"
    assert 0 < len(stream.tokens) < 100
    assert reg.get("serving_deadline_expired_total").value == e0 + 1
    assert eng.state_manager.free_blocks() == free0


def _overload_run(eng, serve, admission, n):
    """Submit ``n`` requests to a runtime whose loop has not started:
    returns the index of each shed request and its reason."""
    async def main():
        serving = serve.ServingEngine(eng, serve.ServingConfig(
            admission=admission))
        shed, streams = [], []
        for i, p in enumerate(_prompts((9, 12, 7, 30, 5, 8), seed=3)[:n]):
            try:
                streams.append(await serving.submit(p, 6))
            except serve.OverloadedError as e:
                shed.append((i, e.reason, e.retry_after_s))
        await serving.stop(drain=False)
        for s in streams:
            await s.drain()
        return shed, [s.status for s in streams]
    return asyncio.run(main())


@pytest.mark.parametrize("limits", [dict(max_pending=3),
                                    dict(max_queued_tokens=40),
                                    dict(max_pending=4,
                                         max_queued_tokens=60)])
def test_overload_sheds_at_the_same_submission_as_jax(engines, limits):
    got = {name: _overload_run(eng, serve,
                               serve.AdmissionConfig(**limits), 6)
           for name, (eng, serve) in engines.items()}
    assert got["torch"] == got["jax"]
    shed, statuses = got["torch"]
    assert shed and all(s == "cancelled" for s in statuses)


def test_http_429_carries_retry_after(engines):
    eng, serve = engines["torch"]

    async def main():
        serving = serve.ServingEngine(eng, serve.ServingConfig(
            admission=serve.AdmissionConfig(max_pending=2,
                                            retry_after_s=2.5)))
        api = serve.ServingAPI(serving)
        host, port = await api.start()
        # the loop is not started: two requests park in the queue, the
        # burst's others are shed at the door
        burst = [asyncio.ensure_future(_http(
            host, port, "POST", "/generate",
            {"prompt": [1, 2, 3], "max_new_tokens": 4}))
            for _ in range(4)]
        done = []
        while len(done) < 2:
            finished, _ = await asyncio.wait(
                [b for b in burst if b not in done],
                return_when=asyncio.FIRST_COMPLETED)
            done.extend(finished)
        shed = [d.result() for d in done]
        await serving.stop(drain=False)
        parked = [await b for b in burst if b not in done]
        await api.stop()
        return shed, parked

    shed, parked = asyncio.run(main())
    for status, hdrs, body in shed:
        assert status == 429 and hdrs["retry-after"] == "3"
        doc = json.loads(body)
        assert doc["reason"] == "queue_full" and doc["retry_after_s"] == 2.5
    for status, _, body in parked:
        assert status == 200
        assert json.loads(body.strip().split(b"\n")[-1])["status"] \
            == "cancelled"


def test_graceful_drain_finishes_every_stream(engines):
    eng, serve = engines["torch"]
    prompts = _prompts(seed=4)
    free0 = eng.state_manager.free_blocks()

    async def main():
        serving = serve.ServingEngine(eng, serve.ServingConfig(
            token_budget=48, chunk=16))
        await serving.start()
        streams = [await serving.submit(p, 6) for p in prompts]
        stop = asyncio.ensure_future(serving.stop(drain=True))
        await asyncio.sleep(0)           # the drain begins
        with pytest.raises(serve.OverloadedError) as ei:
            await serving.submit([1, 2, 3], 4)
        outs = [await s.drain() for s in streams]
        await stop
        return ei.value.reason, streams, outs, serving.health()

    reason, streams, outs, health = asyncio.run(main())
    assert reason == "draining" and health["status"] == "draining"
    assert all(s.status == "completed" for s in streams)
    assert all(len(o) == 6 for o in outs)
    assert eng.state_manager.free_blocks() == free0


# ---------------------------------------------------------------------------
# prefix caching (ROADMAP C's untested surface)
# ---------------------------------------------------------------------------
_PREFIX_COUNTERS = ("inference_prefix_lookups_total",
                    "inference_prefix_hits_total",
                    "inference_prefix_reused_tokens_total",
                    "inference_kv_blocks_allocated_total",
                    "inference_kv_blocks_freed_total")


def _counters(reg):
    out = {}
    for name in _PREFIX_COUNTERS:
        fam = reg.get(name)
        out[name] = fam.value if fam is not None else 0
    return out


def test_prefix_caching_matches_jax(models):
    """Prompts that share 2-4 full blocks, served in three rounds through
    generate() and the scheduler: streams token-identical to the JAX
    engine's, the same number of digests in both prefix indexes, and the
    same prefix-cache counter deltas."""
    rng = np.random.default_rng(9)
    base = list(map(int, rng.integers(1, 127, 64)))
    prompts = [base[:n] + list(map(int, rng.integers(1, 127, k)))
               for n, k in ((64, 5), (48, 20), (32, 3), (64, 17))]
    res = {}
    for name, build, sched_cls, reg in (
            ("jax", _jax_engine, JSched, jax_registry()),
            ("torch", _torch_engine, DynamicSplitFuseScheduler,
             port_registry())):
        eng = build(models, enable_prefix_caching=True)
        c0 = _counters(reg)
        streams = [o.tolist() for o in eng.generate(prompts[:2], 6)]
        streams += [o.tolist() for o in eng.generate(prompts[2:], 6,
                                                     uids=[7, 8])]
        sched = sched_cls(eng, token_budget=48, chunk=16)
        for i, p in enumerate(prompts):
            sched.submit(20 + i, p, 5)
        sched.run()
        streams += [a.tolist() for _, a in sorted(sched.results().items())]
        c1 = _counters(reg)
        res[name] = (streams, len(eng.state_manager._prefix),
                     {k: c1[k] - c0[k] for k in c0})
    assert res["torch"][0] == res["jax"][0]
    assert res["torch"][1] == res["jax"][1] > 0
    assert res["torch"][2] == res["jax"][2]
    assert res["torch"][2]["inference_prefix_hits_total"] > 0


# ---------------------------------------------------------------------------
# the serving surface that is not ported raises with its ROADMAP label
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call,item", [
    ("resume", "A7"), ("begin_handoff", "A7"),
    ("begin_weight_update", "A7"), ("apply_weights", "A7")])
def test_fleet_surface_raises_with_its_label(engines, call, item):
    eng, serve = engines["torch"]
    serving = serve.ServingEngine(eng, serve.ServingConfig())
    args = ({"x": 1},) if call == "resume" else (b"\x00",) if call in (
        "begin_handoff", "begin_weight_update") else ([b"\x00"],)
    try:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            asyncio.run(getattr(serving, call)(*args))
    finally:
        asyncio.run(serving.stop())      # ends the stall-watchdog thread


@pytest.mark.parametrize("what,item", [
    ("autotune", "A12"), ("ragged_off", "A6a"), ("adapter", "A11"),
    ("speculative", "A11"), ("spill", "A9")])
def test_unported_options_raise_with_their_label(engines, models, what,
                                                 item):
    eng, serve = engines["torch"]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        if what == "autotune":
            serve.ServingEngine(eng, serve.ServingConfig(autotune=object()))
        elif what == "ragged_off":
            serve.ServingEngine(eng, serve.ServingConfig(
                ragged_attention="off"))
        elif what == "adapter":
            DynamicSplitFuseScheduler(eng).submit(1, [1, 2, 3], 2,
                                                  adapter="a")
        elif what == "speculative":
            eng.generate([[1, 2, 3]], 2, speculative=True)
        else:
            DSStateManagerConfig(enable_kv_spill=True)

"""Rank body of the parallel serving tests
(``tests/test_torch_parallel_serving.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports
only the port (no ``jax``): two gloo ranks serve ``deepspeed_tpu_torch``
v2 engines on the inputs the test wrote (``inputs.pt``): a small MoE model
at ``expert_parallel_size`` 2 (top-1 and top-2: put and decode logits,
greedy and sampled streams), then the serving runtime over a dense model
at ``tensor_parallel_size`` 2 (rank 0 serves in-process and over HTTP,
rank 1 follows) with and without a faulting engine call, and writes what
each rank saw to ``rank<r>.pt``.
"""

import asyncio
import json
import os

import numpy as np
import torch

MOE_SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, max_seq_len=64,
                 moe_num_experts=4)
DENSE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_layers=2, num_heads=8, num_kv_heads=4, max_seq_len=128)
WORLD = 2
TOP_K = (1, 2)
SAMPLED = dict(temperature=0.8, top_p=0.9, seed=7)


def sm_config():
    from deepspeed_tpu_torch.inference.v2 import DSStateManagerConfig
    return DSStateManagerConfig(max_tracked_sequences=4, max_seq_len=64,
                                num_blocks=33, block_size=8)


def moe_cfg(k):
    return dict(MOE_SMALL, moe_top_k=k)


def v2_engine(model_cfg, weights, **kw):
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    sm = kw.pop("state_manager", None) or sm_config()
    return InferenceEngineV2(
        TransformerLM(TransformerConfig(**model_cfg)),
        RaggedInferenceEngineConfig(state_manager=sm, dtype="float32",
                                    prefill_bucket=16, **kw),
        params=params_from_numpy(weights), device="cpu")


def ep_serve(inp, out):
    """v2 at ep 2: every rank runs the same puts and draws the same
    tokens."""
    for k in TOP_K:
        eng = v2_engine(moe_cfg(k), inp["moe_weights"][k],
                        expert_parallel_size=2)
        out[f"ep_local_e_up_{k}"] = tuple(
            eng.params["layers"]["e_up"].shape)
        out[f"ep_put_{k}"] = np.asarray(eng.put([1], [inp["prompt"]])[0])
        out[f"ep_decode_{k}"] = np.asarray(eng.put([1], [[40]])[0])
        eng.flush(1)
        out[f"ep_tokens_{k}"] = [np.asarray(t) for t in eng.generate(
            inp["prompts"], max_new_tokens=8)]
        out[f"ep_sampled_{k}"] = [np.asarray(t) for t in eng.generate(
            inp["prompts"], max_new_tokens=8, **SAMPLED)]


async def _http(host, port, payload):
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    writer.write((f"POST /generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    _, _, rest = raw.partition(b"\r\n\r\n")
    return [json.loads(ln) for ln in rest.strip().split(b"\n")]


def runtime_tp2(inp, out, rank):
    """The serving runtime over a tp-2 engine: rank 0 serves (in-process
    streams, then one over HTTP), rank 1 follows; a second runtime on the
    same engine stops without draining."""
    from deepspeed_tpu_torch.inference.v2.serve import (ServingAPI,
                                                        ServingConfig,
                                                        ServingEngine)

    eng = v2_engine(DENSE, inp["dense_weights"], tensor_parallel_size=2,
                    state_manager=None)

    async def main():
        serving = ServingEngine(eng, ServingConfig(token_budget=48,
                                                   chunk=16))
        await serving.start()
        out["follower"] = serving.follower
        if not serving.follower:
            streams = [await serving.submit(p, 8) for p in inp["prompts"]]
            out["rt_tokens"] = [await s.drain() for s in streams]
            api = ServingAPI(serving)
            host, port = await api.start()
            lines = await _http(host, port, {"prompt": inp["prompts"][0],
                                             "max_new_tokens": 8})
            out["rt_http"] = lines[-1]["tokens"]
            await api.stop()
        else:
            try:
                await serving.submit([1, 2, 3], 2)
            except RuntimeError as e:
                out["follower_submit"] = str(e)
        await serving.stop(drain=True)
        out["rt_running_after_stop"] = serving.loop_runner.running
        if serving.follower:
            out["follower_calls"] = serving.loop_runner.calls
        # a hard stop with a request in flight ends every rank too
        serving = ServingEngine(eng, ServingConfig())
        await serving.start()
        if not serving.follower:
            stream = await serving.submit(inp["prompts"][1], 32)
            await stream.__anext__()
        await serving.stop(drain=False)
        out["rt_hard_stop_running"] = serving.loop_runner.running

    asyncio.run(main())


def _raise_once(eng, name, after):
    """Make ``eng.<name>``'s next call raise, before or after it runs."""
    real = getattr(eng, name)

    def call(*args, **kwargs):
        setattr(eng, name, real)
        if after:
            real(*args, **kwargs)
        raise RuntimeError(f"injected {name} fault")

    setattr(eng, name, call)


def runtime_faults(inp, out, rank):
    """A put that raises on both ranks fails its request and the runtime
    goes on; a put that raises on the follower alone (after its
    collectives ran) ends both ranks' loops and fails the request."""
    from deepspeed_tpu_torch.inference.v2.serve import (OverloadedError,
                                                        RequestFailed,
                                                        ServingConfig,
                                                        ServingEngine)

    eng = v2_engine(DENSE, inp["dense_weights"], tensor_parallel_size=2,
                    state_manager=None)

    async def serve(tag):
        serving = ServingEngine(eng, ServingConfig(token_budget=48,
                                                   chunk=16))
        await serving.start()
        if not serving.follower:
            got = []
            for p in inp["prompts"][:2]:    # one request at a time
                try:
                    got.append(await (await serving.submit(p, 8)).drain())
                except (RequestFailed, OverloadedError) as e:
                    got.append(f"{type(e).__name__}: {e}")
            out[f"{tag}_streams"] = got
        await serving.stop(drain=True, timeout=60)
        out[f"{tag}_running"] = serving.loop_runner.running
        if serving.follower:
            out[f"{tag}_error"] = serving.loop_runner.error

    _raise_once(eng, "put", after=False)
    asyncio.run(serve("fault_all"))
    if rank == 1:
        _raise_once(eng, "put", after=True)
    asyncio.run(serve("fault_one"))


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    ep_serve(inp, out)
    runtime_tp2(inp, out, rank)
    runtime_faults(inp, out, rank)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()

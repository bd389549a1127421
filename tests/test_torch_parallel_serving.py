"""PyTorch port: expert-parallel serving and the serving runtime over a
tensor-parallel engine, at world 2 over gloo.

One group of two ranks, started by ``torch.multiprocessing.spawn``, runs
every case in turn (``tests/torch_serve_dist_worker.py``, which imports
only the port) and writes what each rank saw; the JAX oracles run in this
process meanwhile. The weights are JAX-initialized (a 4-expert top-1 and
top-2 MoE model, hidden 64; a dense model, hidden 128, 8 heads / 4 kv
heads), fp32.

Held: the v2 engine at ``expert_parallel_size`` 2 (each rank 2 of the 4
experts) gives the put and decode logits of the JAX ``InferenceEngineV2``
at ep 2 on 2 virtual devices within 2e-4, its greedy streams token for
token, and the same sampled streams on both ranks; the serving runtime
over a tp-2 engine (rank 0 serves, rank 1 follows each engine call)
streams in-process and over HTTP what a tp-1 engine generates, a
follower refuses ``submit``, and a drain and a hard stop end both ranks'
loops; an engine call that raises on every rank fails its request only,
and one that raises on the follower alone ends both ranks' loops.
"""

import os
import socket
import time

import numpy as np
import pytest

import jax
import torch
import torch.multiprocessing as mp

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel

import torch_serve_dist_worker as W

torch.set_num_threads(2)

HANG_GUARD_S = 240
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _jax_v2(model_cfg, weights, ep=1):
    from deepspeed_tpu.inference.v2 import (DSStateManagerConfig,
                                            InferenceEngineV2,
                                            RaggedInferenceEngineConfig)
    sm = DSStateManagerConfig(max_tracked_sequences=4, max_seq_len=64,
                              num_blocks=33, block_size=8)
    return InferenceEngineV2(
        JModel(JCfg(**model_cfg)),
        RaggedInferenceEngineConfig(state_manager=sm, dtype="float32",
                                    prefill_bucket=16,
                                    expert_parallel_size=ep),
        params=weights)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("serve_dist"))
    rng = np.random.default_rng(21)
    moe_w = {k: _np_tree(JModel(JCfg(**W.moe_cfg(k))).init_params(
        jax.random.PRNGKey(k))) for k in W.TOP_K}
    dense_w = _np_tree(JModel(JCfg(**W.DENSE)).init_params(
        jax.random.PRNGKey(3)))
    inp = {"moe_weights": moe_w, "dense_weights": dense_w,
           "prompt": rng.integers(1, 128, 11).tolist(),
           "prompts": [rng.integers(1, 128, n).tolist()
                       for n in (9, 14, 5)]}
    torch.save(inp, os.path.join(work, "inputs.pt"))
    ctx = mp.spawn(W.run, args=(W.WORLD, _free_port(), work),
                   nprocs=W.WORLD, join=False)
    t0 = time.monotonic()
    try:
        oracle = {}
        for k in W.TOP_K:
            je = _jax_v2(W.moe_cfg(k), moe_w[k], ep=2)
            oracle[f"ep_put_{k}"] = np.asarray(je.put([1], [inp["prompt"]])[0])
            oracle[f"ep_decode_{k}"] = np.asarray(je.put([1], [[40]])[0])
            je.flush(1)
            oracle[f"ep_tokens_{k}"] = [np.asarray(t) for t in je.generate(
                inp["prompts"], max_new_tokens=8)]
        # the tp-1 port engine's streams (the runtime's oracle)
        teng = W.v2_engine(W.DENSE, dense_w)
        oracle["tp1_tokens"] = [np.asarray(t)[len(p):].tolist() for t, p in
                                zip(teng.generate(inp["prompts"], 8),
                                    inp["prompts"])]
    finally:
        while not ctx.join(timeout=2):
            if time.monotonic() - t0 > HANG_GUARD_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the world-{W.WORLD} group did not finish in "
                            f"{HANG_GUARD_S} s")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(W.WORLD)]
    return {"oracle": oracle, "ranks": ranks}


@pytest.mark.parametrize("k", W.TOP_K)
def test_ep2_serving_matches_jax(results, k):
    o = results["oracle"]
    for r in results["ranks"]:
        assert r[f"ep_local_e_up_{k}"] == (2, 2, 64, 128)
        np.testing.assert_allclose(r[f"ep_put_{k}"], o[f"ep_put_{k}"],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(r[f"ep_decode_{k}"], o[f"ep_decode_{k}"],
                                   **LOGIT_TOL)
        for a, b in zip(r[f"ep_tokens_{k}"], o[f"ep_tokens_{k}"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", W.TOP_K)
def test_ep2_sampled_streams_agree_across_ranks(results, k):
    r0, r1 = results["ranks"]
    for a, b in zip(r0[f"ep_sampled_{k}"], r1[f"ep_sampled_{k}"]):
        np.testing.assert_array_equal(a, b)
    # sampling did not collapse into the greedy stream
    assert any(not np.array_equal(a, b) for a, b in
               zip(r0[f"ep_sampled_{k}"], r0[f"ep_tokens_{k}"]))


def test_runtime_over_tp2_streams_what_tp1_generates(results):
    o = results["oracle"]
    r0, r1 = results["ranks"]
    assert not r0["follower"] and r1["follower"]
    assert r0["rt_tokens"] == o["tp1_tokens"]
    assert r0["rt_http"] == o["tp1_tokens"][0]
    assert "follows" in r1["follower_submit"]
    # the follower made the leader's engine calls (puts, windows, flushes)
    assert r1["follower_calls"] > len(o["tp1_tokens"])


def test_runtime_stop_ends_every_rank(results):
    for r in results["ranks"]:
        assert not r["rt_running_after_stop"]
        assert not r["rt_hard_stop_running"]


def test_runtime_fault_on_every_rank_fails_one_request(results):
    """A put that raised on both ranks fails the request it served; the
    group stays in step and the runtime serves the next one."""
    o = results["oracle"]
    r0, r1 = results["ranks"]
    first, second = r0["fault_all_streams"]
    assert "injected put fault" in first
    assert second == o["tp1_tokens"][1]
    assert r1["fault_all_error"] is None
    assert not r0["fault_all_running"] and not r1["fault_all_running"]


def test_runtime_fault_on_one_rank_ends_the_group(results):
    """A put that raised on the follower alone ends both ranks' loops
    (no rank waits on the other): its request fails, and the runtime
    admits no more."""
    r0, r1 = results["ranks"]
    failed, refused = r0["fault_one_streams"]
    assert failed.startswith("RequestFailed") and "GroupDiverged" in failed
    assert refused.startswith("OverloadedError")
    assert "'put'" in str(r1["fault_one_error"])
    assert not r0["fault_one_running"] and not r1["fault_one_running"]

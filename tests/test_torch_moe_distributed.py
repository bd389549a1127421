"""PyTorch port: MoE and expert parallelism at world 2 over gloo against JAX.

One group of two ranks, started by ``torch.multiprocessing.spawn``, runs
every case in turn (``tests/torch_moe_dist_worker.py``, which imports only
the port) and writes what each rank saw. The JAX oracle is a dp=2
``DeepSpeedTpuEngine`` on two of the test process's virtual CPU devices with
the same ``expert`` axis, whose weights (taken before its first step) and
numpy batches both packages train on: a 2-layer MoE model (4 experts,
top-2 at capacity 1.0, so tokens drop), AdamW, clipping, gas 2, micro 2 a
rank.

Held: losses within 1e-5 relative and master params after 3 steps within
2e-5 absolute of JAX for ep 1 x dp 2 (the gating global over both ranks'
tokens: capacity, positions and aux statistics), ep 2 at ZeRO 1 and 3,
and dropless ep 2; the ranks agree; an ep-2 checkpoint holds one
fragment per expert tensor and loads at world 1 (ep 1) and into the JAX
engine; the safe-mode sweep passes a healthy ep-2 engine (each rank holds
other experts) and reports a replicated leaf one rank changed.
"""

import glob
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
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import torch_moe_dist_worker as W

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

WORLD = 2
HANG_GUARD_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in flat}


def _nested(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _jax_engine(name, world=WORLD, micro=2):
    _, stage, ep = W.CASES[name]
    return JEngine(JModel(JCfg(**W.model_cfg(name))),
                   JDSConfig(W.train_config(stage, ep, micro=micro),
                             world_size=world),
                   topology=MeshTopology(TopologyConfig(expert=ep),
                                         devices=jax.devices()[:world]))


def _master(eng):
    return _flat(eng.master_params if eng.has_master else eng.params)


@pytest.fixture(scope="module")
def oracle():
    rng = np.random.default_rng(11)
    batches = [{"input_ids": rng.integers(0, 128, (2, 2 * WORLD, 64),
                                          dtype=np.int64)}
               for _ in range(W.STEPS)]
    out = {"batches": batches, "weights": {}}
    for name in W.CASES:
        eng = _jax_engine(name)
        out["weights"][name] = _nested(_master(eng))
        out[f"losses_{name}"] = [float(eng.train_batch(batch=b))
                                 for b in batches]
        out[f"params_{name}"] = _master(eng)
    return out


@pytest.fixture(scope="module")
def ranks(oracle, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("moe_dist"))
    torch.save({"weights": oracle["weights"], "batches": oracle["batches"]},
               os.path.join(work, "inputs.pt"))
    ctx = mp.spawn(W.run, args=(WORLD, _free_port(), work), nprocs=WORLD,
                   join=False)
    t0 = time.monotonic()
    while not ctx.join(timeout=2):
        if time.monotonic() - t0 > HANG_GUARD_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the world-{WORLD} group did not finish in "
                        f"{HANG_GUARD_S} s")
    out = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return out, work


@pytest.mark.parametrize("name", sorted(W.CASES))
def test_matches_jax_at_world_2(oracle, ranks, name):
    r0 = ranks[0][0]
    np.testing.assert_allclose(r0[f"losses_{name}"],
                               oracle[f"losses_{name}"], rtol=1e-5)
    for k, v in oracle[f"params_{name}"].items():
        np.testing.assert_allclose(r0[f"params_{name}"][k], v, rtol=0,
                                   atol=2e-5, err_msg=k)
    if name != "ep2_dropless":
        # capacity 1.0 dropped tokens on both ranks (the global gating
        # decides which)
        assert all(r[f"dropped_{name}"] > 0 for r in ranks[0])
    ep = W.CASES[name][2]
    assert r0[f"local_e_up_{name}"][1] == 4 // ep


def test_ranks_agree(ranks):
    r0, r1 = ranks[0]
    for name in W.CASES:
        assert r0[f"losses_{name}"] == r1[f"losses_{name}"]
        for k in r0[f"params_{name}"]:
            np.testing.assert_array_equal(r0[f"params_{name}"][k],
                                          r1[f"params_{name}"][k],
                                          err_msg=f"{name} {k}")


def test_sanity_at_ep2(ranks):
    names = [n for n, c in W.CASES.items() if c[2] > 1]
    for r in ranks[0]:
        for name in names:
            assert r[f"sanity_{name}"] == {"ok": True, "problems": []}, name
        rep = r["sanity_desync_ep2"]
        assert not rep["ok"]
        assert any(p.startswith("params['final_norm']")
                   for p in rep["problems"]), rep
        assert not any("['e_" in p for p in rep["problems"]), rep


def test_ep2_checkpoint_loads_at_world_1_and_in_jax(oracle, ranks):
    r0, work = ranks[0][0], ranks[1]
    ck = os.path.join(work, "ck_ep2")
    # one whole fragment per expert tensor, gathered from the expert ranks
    frags = glob.glob(os.path.join(ck, "*", "params__layers__e_up.npy"))
    assert len(frags) == 1
    assert np.load(frags[0]).shape[1] == 4
    want = r0["params_ep2_z1"]
    # the port at world 1, ep 1
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    cfg = W.train_config(1, 1, micro=2 * WORLD)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**W.model_cfg("ep2_z1"))),
        config=cfg, device="cpu")
    teng.load_checkpoint(ck, tag="t")
    got = W.full_params(teng)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the JAX engine at dp 1
    jeng = _jax_engine("dp2", world=1, micro=2 * WORLD)
    jeng.load_checkpoint(ck, tag="t")
    for k, v in _master(jeng).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # both continue alike
    b = oracle["batches"][0]
    np.testing.assert_allclose(teng.train_batch(batch=b),
                               float(jeng.train_batch(batch=b)), rtol=1e-5)

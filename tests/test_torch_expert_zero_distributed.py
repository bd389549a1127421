"""PyTorch port: expert leaves' ZeRO shards and the expert / sequence /
MiCS / tensor compositions at world 4 over gloo against the JAX package.

One group of four ranks, started by ``torch.multiprocessing.spawn``, runs
every case in turn (``tests/torch_expert_dist_worker.py``, which imports
only the port) and writes what each rank saw; the JAX oracles run in this
process meanwhile. They are ``DeepSpeedTpuEngine``s on
``jax.devices()[:4]`` built with ``TopologyConfig(model=..., seq=...,
expert=..., mics_shard=...)``, whose initial weights (taken before the
first step, the same at every topology) and numpy batches both packages
train on: the MoE test model of ``tests/torch_moe_dist_worker.py``
(2 layers, hidden 64, 4 heads, S 64, fp32) with 4 experts as in
``dryrun_multichip`` (capacity 2.0), AdamW, clipping 0.5, gas 2, a global
micro-batch of 4 rows.

Held: losses within 1e-5 relative and params after 3 steps within 2e-5
absolute of JAX for ``dryrun_multichip`` (c) ep 2 x dp 2 at ZeRO 1,
(c1d) dropless x ep 2, (c2) ep 2 x ZeRO-3, ZeRO-2 and the optimizer
offload at ep 2 x dp 2, tp 2 x ep 2, sp 2 x ep 2 (MoE under Ulysses,
capacity binding), MiCS 2 x ep 2 and MiCS 2 x sp 2; every rank returns
the same loss and holds the same whole params; an expert leaf's master
is cut over the ranks holding the same experts; the safe-mode sweep
passes; a native and a universal checkpoint saved at ep 2 x dp 2 load
back at ep 2, at ep 1 and (native) into the JAX engine.
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
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import torch_expert_dist_worker as W

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

HANG_GUARD_S = 300


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


def _master(eng):
    if getattr(eng, "host_opt", None) is not None:
        return _flat(jax.tree_util.tree_unflatten(
            eng._param_treedef,
            [np.array(x, np.float32)
             for x in eng.host_opt.get_master_leaves()]))
    return _flat(eng.master_params if eng.has_master else eng.params)


def _jax_engine(name, world=W.WORLD):
    stage, tp, sp, mics, ep, _, _ = W.CASES[name]
    if world == 1:
        tp = sp = mics = ep = 1
    return JEngine(JModel(JCfg(**W.model_cfg(name))),
                   JDSConfig(W.train_config(name, world), world_size=world),
                   topology=MeshTopology(
                       TopologyConfig(model=tp, seq=sp, expert=ep,
                                      mics_shard=mics),
                       devices=jax.devices()[:world]))


def _port_ep1(name):
    """The port at world 1 (ep 1, tp 1), the same global batch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**W.model_cfg(name))),
        config=W.train_config(name, 1), device="cpu")
    return eng


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("expert_dist"))
    rng = np.random.default_rng(21)
    batches = [{"input_ids": rng.integers(0, W.SMALL["vocab_size"],
                                          (2, W.ROWS, W.S), dtype=np.int64)}
               for _ in range(W.STEPS + 1)]
    # the initial weights of each model (the same at every topology)
    weights = {n: _master(_jax_engine(n, world=1)) for n in W.CASES}
    inp = {"weights": {n: _nested(w) for n, w in weights.items()},
           "batches": batches}
    torch.save(inp, os.path.join(work, "inputs.pt"))
    ctx = mp.spawn(W.run, args=(W.WORLD, _free_port(), work),
                   nprocs=W.WORLD, join=False)
    t0 = time.monotonic()
    try:
        oracle = {}
        for name in W.CASES:
            eng = _jax_engine(name)
            np.testing.assert_array_equal(_master(eng)["embed"],
                                          weights[name]["embed"])
            oracle[f"losses_{name}"] = [float(eng.train_batch(batch=b))
                                        for b in batches[:W.STEPS]]
            oracle[f"params_{name}"] = _master(eng)
    finally:
        while not ctx.join(timeout=2):
            if time.monotonic() - t0 > HANG_GUARD_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the world-{W.WORLD} group did not finish in "
                            f"{HANG_GUARD_S} s")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(W.WORLD)]
    return {"oracle": oracle, "ranks": ranks, "work": work, "inputs": inp}


@pytest.mark.parametrize("name", list(W.CASES))
def test_matches_jax_at_world_4(results, name):
    o, ranks = results["oracle"], results["ranks"]
    r0 = ranks[0]
    np.testing.assert_allclose(r0[f"losses_{name}"], o[f"losses_{name}"],
                               rtol=1e-5)
    for k, v in o[f"params_{name}"].items():
        np.testing.assert_allclose(r0[f"params_{name}"][k], v, rtol=0,
                                   atol=2e-5, err_msg=k)
    # every rank returns the same loss and holds the same whole params
    for r in ranks[1:]:
        assert r[f"losses_{name}"] == r0[f"losses_{name}"]
        for k in r0[f"params_{name}"]:
            np.testing.assert_array_equal(r[f"params_{name}"][k],
                                          r0[f"params_{name}"][k],
                                          err_msg=f"{name} {k}")
    for r in ranks:
        assert r[f"sanity_{name}"] == {"ok": True, "problems": []}


def test_expert_leaves_shard_over_their_expert_data_ranks(results):
    """e_up [L, E, H, F]: a rank holds E / ep experts; its master is cut
    on F (the largest free dimension) over the ranks holding the same
    experts: the 2 data ranks at ep 2 x dp 2, the MiCS shard group, the 2
    seq ranks at sp 2 x ep 2; at tp 2 x ep 2 the tensor-parallel cut
    halves F and the expert-data group is one rank."""
    r0 = results["ranks"][0]
    assert r0["local_c_ep2_dp2_z1"]["e_up"] == (2, 2, 64, 128)
    assert r0["master_c_ep2_dp2_z1"]["layers/e_up"] == (2, 2, 64, 64)
    assert r0["local_c2_ep2_z3"]["e_up"] == (2, 2, 64, 64)
    assert r0["master_ep2_dp2_z2"]["layers/e_up"] == (2, 2, 64, 64)
    assert r0["master_tp2_ep2_z1"]["layers/e_up"] == (2, 2, 64, 64)
    assert r0["master_sp2_ep2_z2"]["layers/e_up"] == (2, 2, 64, 64)
    assert r0["local_mics2_ep2_z3"]["e_up"] == (2, 2, 64, 64)
    # a dense leaf is cut over every ZeRO rank
    assert r0["master_c_ep2_dp2_z1"]["layers/wq"] == (2, 16, 64)


def test_ep2_checkpoints_reload_at_ep2(results):
    for r in results["ranks"]:
        want = r["params_c_ep2_dp2_z1"]
        for kind in ("native", "universal"):
            for k, v in want.items():
                np.testing.assert_array_equal(r[f"reload_{kind}"][k], v,
                                              err_msg=f"{kind} {k}")
        np.testing.assert_allclose(r["reload_native_next"], r["next_c"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["reload_universal_next"], r["next_c"],
                                   rtol=1e-6)


def test_ep2_checkpoints_load_at_ep1_and_in_jax(results):
    """Whole expert leaves in the checkpoint: the native one loads into
    the port at world 1 (ep 1) and into the JAX engine; the universal
    directory into the port at ep 1."""
    r0, work = results["ranks"][0], results["work"]
    name = "c_ep2_dp2_z1"
    want = r0[f"params_{name}"]
    b = results["inputs"]["batches"][W.STEPS]
    teng = _port_ep1(name)
    teng.load_checkpoint(os.path.join(work, "ck_ep2"), tag="t")
    got = W.full_params(teng)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jeng = _jax_engine(name, world=1)
    jeng.load_checkpoint(os.path.join(work, "ck_ep2"), tag="t")
    for k, v in _master(jeng).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_allclose(teng.train_batch(batch=b),
                               float(jeng.train_batch(batch=b)), rtol=1e-5)
    teng.close()
    ueng = _port_ep1(name)
    ueng.load_universal_checkpoint(os.path.join(work, "uni_ep2"))
    got = W.full_params(ueng)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_allclose(ueng.train_batch(batch=b), r0["next_c"],
                               rtol=1e-5)
    ueng.close()


# dryrun_multichip's model (_flagship_cfg(small=True)) with its MoE mode's
# experts (c), the width this file's group does not train at
FLAGSHIP_SMALL_MOE = dict(vocab_size=256, hidden_size=128,
                          intermediate_size=256, num_layers=2, num_heads=8,
                          num_kv_heads=4, max_seq_len=128, moe_num_experts=4,
                          moe_capacity_factor=2.0)
GRAD_ATOL = 1e-7     # f32 rounding of gradients up to ~3e-2


def test_flagship_small_moe_grads_match_jax():
    """Why the group above trains the hidden-64 model: at the flagship-small
    MoE width both packages compute each micro-batch's loss and gradients
    alike (within ``GRAD_ATOL``), but on the seed-19 batches the two
    micro-batches' gradients of ``layers/wo[1, 93, 40]`` (each ~5.3e-3)
    cancel to ~2e-9, the size of their f32 rounding. The sum's sign is
    then rounding noise (JAX's and the port's differ), and AdamW's first
    step, which moves an element by ~lr * g / (|g| + eps), sends that one
    element ~8e-5 one way in JAX and the other way in the port: the
    1.6e-4 gap after one step at world 1. Every other element holds to
    2e-5."""
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.runtime.engine import _flatten

    jeng = JEngine(JModel(JCfg(**FLAGSHIP_SMALL_MOE)),
                   JDSConfig(W.train_config("c_ep2_dp2_z1", 1),
                             world_size=1),
                   topology=MeshTopology(TopologyConfig(),
                                         devices=jax.devices()[:1]))
    w = _master(jeng)
    jm = JModel(JCfg(**FLAGSHIP_SMALL_MOE))

    def jloss(p, ids):
        return jm.apply(p, {"input_ids": ids}, train=True)

    jgrad = jax.jit(jax.value_and_grad(jloss))
    tm = TransformerLM(TransformerConfig(**FLAGSHIP_SMALL_MOE))
    ids = np.random.default_rng(19).integers(0, 256, (2, 4, 64))
    elem = ("layers/wo", (1, 93, 40))
    micro = {"jax": [], "torch": []}
    for b in ids:
        jl, jg = jgrad(_nested(w), b)
        jg = _flat(jg)
        tp = params_from_numpy(_nested(w))
        leaves = dict(_flatten(tp))
        for v in leaves.values():
            v.requires_grad_(True)
        tl = tm.apply(tp, {"input_ids": torch.as_tensor(b)})
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        for k, v in leaves.items():
            np.testing.assert_allclose(v.grad.numpy(), jg[k], rtol=0,
                                       atol=GRAD_ATOL, err_msg=k)
        micro["jax"].append(float(jg[elem[0]][elem[1]]))
        micro["torch"].append(float(leaves[elem[0]].grad[elem[1]]))
    for g in micro.values():
        assert min(abs(x) for x in g) > 1e-3
        assert abs(sum(g)) < 2 * GRAD_ATOL

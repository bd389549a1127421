"""PyTorch port: ZeRO 0-3 at world 2 over gloo against the JAX package.

One group of two ranks, started by ``torch.multiprocessing.spawn``, runs
every multi-rank case of the port in turn (``tests/torch_dist_worker.py``,
which imports only the port) and writes what each rank saw. The JAX
oracle is a dp=2 ``DeepSpeedTpuEngine`` on two of the session's virtual
CPU devices, built as ``_dp_baseline_loss`` builds dp=1, whose weights
(taken before its first step) and numpy batches both packages train on:
the flagship small model (2 layers, fp32), AdamW, a warmup schedule,
clipping, gas 2, micro 2 a rank.

Held: losses within 1e-5 relative and params after 3 steps within 2e-5
absolute of JAX at stages 0-3; bucketed and off reduction ``torch.equal``
at gas 1 and 2; an fp16 overflow in one rank's rows skipped on both ranks;
the returned loss the mean of the ranks' own; a checkpoint saved at world
2 resumes at world 1 and one saved at world 1 at world 2.
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

import torch_dist_worker as W

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

WORLD, STEPS = 2, 3
HANG_GUARD_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_weights(eng):
    tree = eng.master_params if eng.has_master else eng.params
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


@pytest.fixture(scope="module")
def oracle():
    """The JAX dp=2 engines at stages 0-3: weights, batches, losses and
    the weights after 3 steps."""
    rng = np.random.default_rng(7)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2 * WORLD, 128),
                                          dtype=np.int64)}
               for _ in range(5)]
    out = {"batches": batches}
    for stage in range(4):
        ds = JDSConfig(W.train_config(stage), world_size=WORLD)
        topo = MeshTopology(TopologyConfig(), devices=jax.devices()[:WORLD])
        eng = JEngine(JModel(JCfg(**W.FLAGSHIP_SMALL)), ds, topology=topo)
        w = _jax_weights(eng)
        if stage == 0:
            out["weights"] = w
        for k, v in w.items():   # one init at every stage
            np.testing.assert_array_equal(v, out["weights"][k])
        out[f"losses{stage}"] = [float(eng.train_batch(batch=b))
                                 for b in batches[:STEPS]]
        out[f"gnorm{stage}"] = float(eng.get_global_grad_norm())
        out[f"params{stage}"] = _jax_weights(eng)
    return out


@pytest.fixture(scope="module")
def ranks(oracle, tmp_path_factory):
    """Both ranks' results, after the test's own world-1 run that writes
    the checkpoint the ranks resume from."""
    work = str(tmp_path_factory.mktemp("dist"))
    weights = _nested(oracle["weights"])
    batches = oracle["batches"]
    torch.save({"weights": weights, "batches": batches},
               os.path.join(work, "inputs.pt"))
    # world 1, stage 3, the same global batch (micro 4): 3 steps, save,
    # 2 more
    eng = W._engine(W.train_config(3, micro=2 * WORLD), weights)
    W._train(eng, batches[:STEPS])
    eng.save_checkpoint(os.path.join(work, "ckpt_w1"), tag="s3")
    w1 = {"cont_losses": W._train(eng, batches[STEPS:STEPS + 2]),
          "cont_params": W._full_params(eng)}
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
    return out, w1, work


def _close(a, b, atol):
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def test_group_is_gloo_at_world_2(ranks):
    for r in ranks[0]:
        assert r["backend"] == "gloo" and r["world"] == WORLD


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_matches_jax_dp2(oracle, ranks, stage):
    r0 = ranks[0][0]
    np.testing.assert_allclose(r0[f"losses{stage}"],
                               oracle[f"losses{stage}"], rtol=1e-5)
    _close(r0[f"params{stage}"], oracle[f"params{stage}"], 2e-5)
    # the norm sums the shards' partial sums over the group (and clipping
    # at 0.5 bites: the last step's norm is above it)
    assert r0[f"gnorm{stage}"] == pytest.approx(oracle[f"gnorm{stage}"],
                                                rel=1e-5)
    assert oracle[f"gnorm{stage}"] > 0.5
    # auto: bucketed on a data-parallel world at stages 0-2, as in JAX
    assert r0[f"mode{stage}"] == ("off" if stage == 3 else "bucketed")


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_ranks_agree(ranks, stage):
    """Every rank returns the same loss and holds the same weights (the
    replicated leaves did not drift apart)."""
    r0, r1 = ranks[0]
    assert r0[f"losses{stage}"] == r1[f"losses{stage}"]
    for k in r0[f"params{stage}"]:
        np.testing.assert_array_equal(r0[f"params{stage}"][k],
                                      r1[f"params{stage}"][k], err_msg=k)


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bucketed_equals_off(ranks, stage, gas):
    """The port's counterpart of JAX
    ``test_bucketed_matches_monolithic_bit_identical``."""
    for r in ranks[0]:
        mode_b, losses_b, params_b, nb = r[f"ovl{stage}_{gas}_bucketed"]
        mode_o, losses_o, params_o, _ = r[f"ovl{stage}_{gas}_off"]
        assert (mode_b, mode_o) == ("bucketed", "off")
        assert nb >= 1          # stage 3: its persistent leaves bucket
        assert losses_b == losses_o
        for k in params_b:
            np.testing.assert_array_equal(params_b[k], params_o[k],
                                          err_msg=k)


@pytest.mark.parametrize("stage", [2, 3])
def test_fp16_overflow_on_one_rank_skips_on_both(ranks, stage):
    r0, r1 = (r[f"fp16_{stage}"] for r in ranks[0])
    # after the reduce-scatter only rank 1's shard overflowed ...
    assert r0["local_finite"] and not r1["local_finite"]
    # ... and both ranks skipped the step, with the same scale
    for r in (r0, r1):
        assert r["skipped"] == 1 and r["unchanged"]
        assert r["loss_scale"] == 2.0 ** 16
    assert r0["loss"] == r1["loss"]


def test_returned_loss_is_the_global_mean(ranks):
    r0, r1 = ranks[0]
    local = r0["local_losses"]
    assert local == r1["local_losses"] and local[0] != local[1]
    assert r0["returned_loss"] == r1["returned_loss"]
    assert r0["returned_loss"] == pytest.approx(np.mean(local), rel=1e-6)


def test_world2_checkpoint_resumes_at_world1(oracle, ranks):
    """Saved by the world-2 stage-3 engine after 3 steps; loaded by a
    world-1 stage-3 engine of the same global batch, which continues as
    the world-2 engine did."""
    out, _, work = ranks
    eng = W._engine(W.train_config(3, micro=2 * WORLD),
                    _nested(oracle["weights"]))
    eng.load_checkpoint(os.path.join(work, "ckpt_w2"), tag="s3")
    assert eng.global_steps == STEPS
    losses = W._train(eng, oracle["batches"][STEPS:STEPS + 2])
    np.testing.assert_allclose(losses, out[0]["cont_losses"], rtol=1e-5)
    _close(W._full_params(eng), out[0]["cont_params"], 2e-5)


def test_world1_checkpoint_resumes_at_world2(ranks):
    out, w1, _ = ranks
    for r in out:
        np.testing.assert_allclose(r["w1_cont_losses"], w1["cont_losses"],
                                   rtol=1e-5)
        _close(r["w1_cont_params"], w1["cont_params"], 2e-5)

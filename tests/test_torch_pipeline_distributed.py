"""PyTorch port: pipeline parallelism at world 4 over gloo against the JAX
package.

One group of four ranks, started by ``torch.multiprocessing.spawn``, runs
every case in turn (``tests/torch_pipe_dist_worker.py``, which imports
only the port) and writes what each rank saw; the JAX oracles run in this
process meanwhile. They are ``DeepSpeedTpuEngine``s on
``jax.devices()[:4]`` built with ``TopologyConfig(pipe=..., model=...,
seq=..., expert=...)``, each built before the ranks start so that its
initial weights (taken before its first step) are the port's: the JAX
pipeline test model (4 layers, hidden 64, 4 heads, S 64, fp32; and a
4-expert top-1 variant) and the JAX ``PipelineModule`` test layer lists
(hidden 32), AdamW, clipping 1.0, M = gas 4, a global micro-batch of 4
rows.

Held: losses within 1e-5 relative and params after 3 steps within 2e-5
absolute of JAX at pp 2 x dp 2 (ZeRO 0 and 1), pp 4, the MoE model at
pp 2 x dp 2 (aux on) and pp 2 x ep 2 (aux off and on), the host C++
optimizer at pp 2 x dp 2 (fp32; in bf16 the params by their updates, see
``UPDATE_FRACTION``), ``PipelineModule`` at pp 2 x tp 2,
pp 2 x sp 2 and pp 1 x sp 2 (column / row layers; at pp 1 the engine's
manual seq mode), with tied layers, with stacked
storage at pp 4 and with stacked and replicated layers at pp 2 x dp 2;
every rank returns the same loss and holds the same whole params;
pp 2 x dp 2 equals the port's own pp 1 on the same global batch;
``eval_batch`` equals JAX's; fp16 warns and trains within 1e-4 relative
of JAX's fp16 run in the losses, for the TransformerLM (finite and
falling; params by their updates) and the mixed layer list (params
within 2e-5); ZeRO 3, fp16 x offload
and the shims refuse as JAX does; a native checkpoint saved at pp 2 loads
at pp 1 and into the JAX engine; a ``PipelineModule`` universal directory
goes pp 4 -> pp 1 -> pp 4.
"""

import os
import socket
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from deepspeed_tpu import LayerSpec as JLayerSpec
from deepspeed_tpu import PipelineModule as JPipelineModule
from deepspeed_tpu import TiedLayerSpec as JTiedLayerSpec
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

import torch_pipe_dist_worker as W

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

HANG_GUARD_S = 300
FP16_RTOL = 1e-4       # measured 3.7e-6 (the same fp16 casts in both)
LR = 1e-3              # train_config's AdamW
# bf16 / fp16 compute: a gradient element near 0 may take the other sign
# in the other package, and AdamW then moves it by up to lr the other way
# in that step. Such a run is held by its updates (after - before): none
# more than 2 lr a step from JAX's, and all but this fraction of the
# elements within 0.1 lr of it (measured on this model: 1.17% of the
# elements in bf16 with offload, 0.17% in fp16; an update that is missing
# or has the wrong sign is beyond 0.1 lr almost everywhere)
UPDATE_FRACTION = {"offload_bf16_pp2": 0.02, "fp16": 0.005}


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


def _hold_updates(got, want, before, fraction):
    """The updates of ``got`` against ``want`` from the weights ``before``
    (``UPDATE_FRACTION``)."""
    far = total = 0
    for k, v in want.items():
        gap = np.abs((got[k] - before[k]) - (v - before[k]))
        assert gap.max() <= 2 * LR * W.STEPS, (k, gap.max())
        far += int((gap > 0.1 * LR).sum())
        total += gap.size
    assert far <= fraction * total, (
        f"{far} of {total} elements' updates differ from JAX's by more "
        f"than 0.1 lr (at most {fraction:.2%} may)")


def _master(eng):
    if getattr(eng, "host_opt", None) is not None:
        return _flat(jax.tree_util.tree_unflatten(
            eng._param_treedef,
            [np.array(x, np.float32)
             for x in eng.host_opt.get_master_leaves()]))
    return _flat(eng.master_params if eng.has_master else eng.params)


# -- the JAX package's PipelineModule test layers (tests/unit/pipe) -------
class JLinear:
    def __init__(self, d_in, d_out, act=True, seed_scale=0.2):
        self.d_in, self.d_out, self.act = d_in, d_out, act
        self.seed_scale = seed_scale

    def init(self, rng):
        w = jax.random.normal(rng, (self.d_in, self.d_out),
                              jnp.float32) * self.seed_scale
        return {"w": w, "b": jnp.zeros((self.d_out,), jnp.float32)}

    def apply(self, params, x):
        y = x @ params["w"] + params["b"]
        return jax.nn.tanh(y) if self.act else y


class JCol(JLinear):
    axis = "model"

    def partition_spec(self, topo):
        on = topo.axis_size(self.axis) > 1
        return {"w": P(None, self.axis) if on else P(),
                "b": P(self.axis) if on else P()}

    def apply(self, params, x):
        from deepspeed_tpu.comm.comm import tp_copy
        return super().apply(params, tp_copy(x, self.axis))


class JRow(JLinear):
    axis = "model"

    def partition_spec(self, topo):
        on = topo.axis_size(self.axis) > 1
        return {"w": P(self.axis, None) if on else P(), "b": P()}

    def apply(self, params, x):
        from deepspeed_tpu.comm.comm import tp_reduce
        y = tp_reduce(x @ params["w"], self.axis) + params["b"]
        return jax.nn.tanh(y) if self.act else y


class JSeqCol(JCol):
    axis = "seq"


class JSeqRow(JRow):
    axis = "seq"


class JInProj(JLinear):
    pass


def _j_head(params, x):
    return x @ params["w"].T


def _j_mse(out, batch):
    return jnp.mean((out - batch["y"].astype(jnp.float32)) ** 2)


def _j_layers(kind):
    H = W.HID
    if kind == "pm_tp":
        return [JLayerSpec(JCol, H, 2 * H), JLayerSpec(JRow, 2 * H, H),
                JLayerSpec(JCol, H, 2 * H),
                JLayerSpec(JRow, 2 * H, H, act=False)]
    if kind == "pm_sp":
        return [JLayerSpec(JSeqCol, H, 2 * H), JLayerSpec(JSeqRow, 2 * H, H),
                JLayerSpec(JSeqCol, H, 2 * H),
                JLayerSpec(JSeqRow, 2 * H, H, act=False)]
    if kind == "pm_tied":
        return [JTiedLayerSpec("proj", JInProj, H, H, act=False),
                JLayerSpec(JLinear, H, H), JLayerSpec(JLinear, H, H),
                JTiedLayerSpec("proj", JInProj, H, H, act=False,
                               forward_fn=_j_head)]
    if kind == "pm_mixed":
        return ([JLayerSpec(JInProj, H, H, act=False)]
                + [JLayerSpec(JLinear, H, H) for _ in range(4)]
                + [JLayerSpec(JInProj, H, H, act=False)])
    return [JLayerSpec(JLinear, H, H) for _ in range(8)]


def _jax_engine(name, config=None):
    kind, pp, cfg, _ = W.CASES[name]
    config = config or W.train_config(name)
    ep = config.get("moe", {}).get("expert_parallel_size", 1)
    topo = TopologyConfig(pipe=config["pipeline"]["stages"],
                          model=config.get("tensor_parallel_size", 1),
                          seq=config.get("sequence_parallel_size", 1),
                          expert=ep)
    model = (JModel(JCfg(**W.lm_cfg(name))) if kind == "lm" else
             JPipelineModule(_j_layers(kind), _j_mse,
                             partition_method="uniform", input_ndim=2))
    return JEngine(model, JDSConfig(config, world_size=W.WORLD),
                   topology=MeshTopology(topo,
                                         devices=jax.devices()[:W.WORLD]))


def _jax_pp1(weights_engine_cfg):
    """A dp=1 JAX engine of the pipeline test model (the checkpoint
    oracle)."""
    cfg = dict(weights_engine_cfg, pipeline={"stages": 1},
               train_micro_batch_size_per_gpu=W.ROWS)
    return JEngine(JModel(JCfg(**W.LM)), JDSConfig(cfg, world_size=1),
                   topology=MeshTopology(TopologyConfig(),
                                         devices=jax.devices()[:1]))


def _port_pp1(weights, cfg):
    """The port at world 1, pp 1, the same global batch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    cfg = dict(cfg, pipeline={"stages": 1},
               train_micro_batch_size_per_gpu=W.ROWS)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**W.LM)), config=cfg,
        device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("pipe_dist"))
    rng = np.random.default_rng(20)
    batches = {
        "lm": [{"input_ids": rng.integers(0, W.VOCAB, (W.GAS, W.ROWS, W.S),
                                          dtype=np.int64)}
               for _ in range(W.STEPS + 1)],
        "pm": [{"x": rng.standard_normal((W.GAS, W.ROWS, W.HID)
                                         ).astype(np.float32),
                "y": rng.standard_normal((W.GAS, W.ROWS, W.HID)
                                         ).astype(np.float32)}
               for _ in range(W.STEPS + 1)]}
    # every oracle is built first: its initial weights are the ranks'
    engines = {name: _jax_engine(name) for name in W.CASES}
    for run_name, name in W.FP16_RUNS.items():
        engines[run_name] = _jax_engine(name, W.train_config(name, **W.FP16))
    weights = {n: _master(e) for n, e in engines.items()}
    inp = {"weights": {n: _nested(w) for n, w in weights.items()},
           "batches": batches}
    torch.save(inp, os.path.join(work, "inputs.pt"))
    ctx = mp.spawn(W.run, args=(W.WORLD, _free_port(), work),
                   nprocs=W.WORLD, join=False)
    t0 = time.monotonic()
    try:
        oracle = {}
        for name, eng in engines.items():
            b = W.batch_for(W.FP16_RUNS.get(name, name), batches)
            oracle[f"losses_{name}"] = [float(eng.train_batch(batch=x))
                                        for x in b[:W.STEPS]]
            oracle[f"params_{name}"] = _master(eng)
            if name in ("pp2_dp2_z0", "pm_stacked_pp4"):
                oracle[f"eval_{name}"] = float(eng.eval_batch(
                    batch=b[W.STEPS]))
        # the port at world 1, pp 1 on pp2_dp2_z0's weights and batches
        teng = _port_pp1(inp["weights"]["pp2_dp2_z0"],
                         W.train_config("pp2_dp2_z0"))
        pp1 = {"losses": [teng.train_batch(batch=x)
                          for x in batches["lm"][:W.STEPS]],
               "params": W.full_params(teng)}
        teng.close()
    finally:
        while not ctx.join(timeout=2):
            if time.monotonic() - t0 > HANG_GUARD_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the world-{W.WORLD} group did not finish in "
                            f"{HANG_GUARD_S} s")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(W.WORLD)]
    return {"oracle": oracle, "ranks": ranks, "work": work, "pp1": pp1,
            "inputs": inp}


@pytest.mark.parametrize("name", list(W.CASES))
def test_matches_jax_at_world_4(results, name):
    o, ranks = results["oracle"], results["ranks"]
    r0 = ranks[0]
    np.testing.assert_allclose(r0[f"losses_{name}"], o[f"losses_{name}"],
                               rtol=1e-5)
    if name in UPDATE_FRACTION:
        _hold_updates(r0[f"params_{name}"], o[f"params_{name}"],
                      _flat(results["inputs"]["weights"][name]),
                      UPDATE_FRACTION[name])
    else:
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


def test_each_stage_holds_its_slices(results):
    """A stage holds its L / pp layers of the stack; a stacked run its
    [k, ...] members; a tensor-parallel layer its columns."""
    for r in results["ranks"]:
        assert r["local_pp2_dp2_z0"]["layers/wq"] == (2, 64, 64)
        assert r["local_pp4"]["layers/wq"] == (1, 64, 64)
        assert r["local_moe_pp2_ep2"]["layers/e_gate"] == (2, 2, 64, 128)
        assert r["local_pm_stacked_pp4"]["stack_000/w"] == (2, W.HID, W.HID)
        assert r["local_pm_pp2_tp2"]["layer_000/w"] == (W.HID, W.HID)
        assert r["local_pm_pp2_sp2"]["layer_001/w"] == (W.HID, W.HID)
        # at pp 1 the seq-owning layers hold their seq slices too (the
        # engine's manual seq mode, not Ulysses)
        assert r["local_pm_pp1_sp2"]["layer_001/w"] == (W.HID, W.HID)
        assert "tied/proj/w" in r["local_pm_tied_pp4"]


def test_pipeline_matches_the_port_at_pp1(results):
    """pp 2 x dp 2 against the port's own world-1 pp 1 engine on the same
    global batch (JAX test_pipeline_matches_dp)."""
    r0, pp1 = results["ranks"][0], results["pp1"]
    np.testing.assert_allclose(r0["losses_pp2_dp2_z0"], pp1["losses"],
                               rtol=1e-5)
    for k, v in pp1["params"].items():
        np.testing.assert_allclose(r0["params_pp2_dp2_z0"][k], v, rtol=0,
                                   atol=2e-5, err_msg=k)


def test_eval_matches_jax(results):
    o = results["oracle"]
    for r in results["ranks"]:
        np.testing.assert_allclose(r["eval_pp2_dp2"],
                                   o["eval_pp2_dp2_z0"], rtol=1e-5)
        np.testing.assert_allclose(r["eval_pm_stacked"],
                                   o["eval_pm_stacked_pp4"], rtol=1e-5)


@pytest.mark.parametrize("run_name", list(W.FP16_RUNS))
def test_fp16_warns_and_trains_like_jax(results, run_name):
    """fp16 takes autograd through ``model.apply``: the TransformerLM's
    pipelined forward (each replicated leaf's stage contributions summed
    over the pipe group), and ``PipelineModule``'s whole layer list (the
    stacked leaves gathered, each stage keeping its slice's gradient).
    The layer list computes in f32 (fp16 weights promoted, as in jnp), so
    its params are held within 2e-5 (measured 1.3e-6); the TransformerLM
    computes in fp16 and is held by its updates."""
    o = results["oracle"]
    before = _flat(results["inputs"]["weights"][run_name])
    for r in results["ranks"]:
        warned = r[f"{run_name}_warned"]
        assert any("1F1B" in m and "fp16" in m for m in warned), warned
        losses = r[f"losses_{run_name}"]
        assert np.isfinite(losses).all()
        if run_name == "fp16":
            # the language model learns; the layer list's targets are noise
            assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, o[f"losses_{run_name}"],
                                   rtol=FP16_RTOL)
        if run_name in UPDATE_FRACTION:
            _hold_updates(r[f"params_{run_name}"], o[f"params_{run_name}"],
                          before, UPDATE_FRACTION[run_name])
        else:
            for k, v in o[f"params_{run_name}"].items():
                np.testing.assert_allclose(r[f"params_{run_name}"][k], v,
                                           rtol=0, atol=2e-5, err_msg=k)


def test_refusals_match_jax(results):
    for r in results["ranks"]:
        kind, msg = r["zero3"]
        assert kind == "AssertionError" and "ZeRO stage <= 1" in msg
        kind, msg = r["fp16_offload"]
        assert kind == "ConfigError" and "bf16" in msg
        assert not r["fp16_offload_host_built"]
        for shim in ("shim_forward", "shim_backward", "shim_step"):
            assert r[shim][0] == "RuntimeError", r[shim]
            assert "pipeline mode" in r[shim][1]


def test_pp2_checkpoint_loads_at_pp1_and_in_jax(results):
    """A checkpoint saved at pp 2 x dp 2 (ZeRO 1) holds whole leaves: it
    loads into the port at pp 1 and into the JAX engine."""
    r0, work = results["ranks"][0], results["work"]
    want = r0["params_pp2_dp2_z1"]
    cfg = W.train_config("pp2_dp2_z1")
    ck = os.path.join(work, "ck_pp2")
    teng = _port_pp1(None, cfg)
    teng.load_checkpoint(ck, tag="t")
    got = W.full_params(teng)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    jeng = _jax_pp1(cfg)
    jeng.load_checkpoint(ck, tag="t")
    for k, v in _master(jeng).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    b = results["inputs"]["batches"]["lm"][W.STEPS]
    np.testing.assert_allclose(teng.train_batch(batch=b),
                               float(jeng.train_batch(batch=b)), rtol=1e-5)
    teng.close()


def test_universal_round_trip_across_pipeline_topologies(results):
    """PipelineModule stacked storage through the universal format: pp 4
    -> pp 1 (per-layer keys) -> pp 4 (re-stacked) (JAX
    test_universal_checkpoint.py:170)."""
    for r in results["ranks"]:
        assert r["uni_local_stack"] == (2, W.HID, W.HID)
        assert not any(k.startswith("stack_") for k in r["uni_pp1_keys"])
        assert r["uni_pp1_equal"] and r["uni_pp1_step"]
        assert r["uni_pp4_equal"]
        assert np.isfinite(r["uni_pp4_next"])

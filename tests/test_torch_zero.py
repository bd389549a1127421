"""PyTorch port: the ZeRO plan, the bucket plan, the config surface and the
one-rank identities of ``deepspeed_tpu_torch``'s data parallelism.

Held against the JAX package on the CPU: ``add_zero_axes`` spec for spec;
the port's per-leaf shard dimensions against JAX ``build_zero_plan``'s
``PartitionSpec`` for every leaf of the flagship small model at worlds 2
and 4 and persistence thresholds 0 and 100000; ``order_units`` and
``build_bucket_plan`` bucket for bucket, and the engine's bucket plan
against a JAX dp=2 engine's; ``estimate_zero_memory``. Then, in this
process (one rank): the config admits the ZeRO keys and names the ROADMAP
item of each key it does not run; the topology and comm surfaces; stages
1-3, bucketed and off, equal stage 0 bit for bit; and under remat a
stage-3 layer is gathered again in its recompute.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology as JTopo
from deepspeed_tpu.parallel.topology import TopologyConfig as JTopoCfg
from deepspeed_tpu.runtime import grad_overlap as jgo
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine
from deepspeed_tpu.runtime.zero import partition as jpart
from jax.sharding import PartitionSpec as P

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import quantized as tq
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime import grad_overlap as tgo
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.zero import partition as tpart

import torch_dist_worker as W

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)


def _jax_shapes(cfg=W.FLAGSHIP_SMALL):
    model = JModel(JCfg(**cfg))
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return shapes, {"/".join(k.key for k in path): tuple(v.shape)
                    for path, v in flat}


def _spec_dim(spec):
    for i, e in enumerate(spec):
        if e is not None:
            return i
    return None


# ---------------------------------------------------------------------------
# the ZeRO plan
# ---------------------------------------------------------------------------
_SHAPES = [(8,), (6, 4), (4, 6), (2, 8, 8), (3, 5), (16, 2, 4), (1,), (),
           (4, 4, 4), (32000, 4096), (4, 4096, 14336)]
_BASES = [None, (None, "model"), ("model",), ("expert", None, None)]


@pytest.mark.parametrize("zero_size", [1, 2, 4])
@pytest.mark.parametrize("threshold", [0, 20])
def test_add_zero_axes_matches_jax(zero_size, threshold):
    sizes = {"data": zero_size, "shard": 1, "expert": 2, "model": 2}
    for shape in _SHAPES:
        for base in _BASES:
            if base is not None and len(base) > len(shape):
                continue
            for axes in (("data",), ("data", "shard"), ("data", "expert")):
                for kw in ({}, {"axis_sizes": sizes}):
                    ref = jpart.add_zero_axes(
                        shape, None if base is None else P(*base), axes,
                        zero_size, threshold=threshold, **kw)
                    got = tpart.add_zero_axes(shape, base, axes, zero_size,
                                              threshold=threshold, **kw)
                    assert got == tuple(ref), (shape, base, axes, kw)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("threshold", [0, 100000])
def test_plan_shard_dims_match_jax_build_zero_plan(world, threshold):
    shapes, flat = _jax_shapes()
    topo = JTopo(JTopoCfg(), devices=jax.devices()[:world])
    for stage in range(4):
        ref = jpart.build_zero_plan(topo, stage, shapes,
                                    persistence_threshold=threshold)
        got = tpart.build_zero_plan(world, stage, flat,
                                    persistence_threshold=threshold)
        for field, dims in (("param_sharding", got.param_dims),
                            ("grad_sharding", got.grad_dims),
                            ("master_sharding", got.master_dims)):
            rflat, _ = jax.tree_util.tree_flatten_with_path(
                getattr(ref, field))
            for path, ns in rflat:
                name = "/".join(k.key for k in path)
                assert dims[name] == _spec_dim(ns.spec), \
                    (stage, field, name, ns.spec)


def test_world_one_plan_keeps_the_dims():
    """The port's one deliberate difference: at world 1 every leaf keeps
    its shard dimension (one shard = the whole leaf), so a one-rank run
    takes the sharded path; JAX's plan is replicated there."""
    _, flat = _jax_shapes()
    plan = tpart.build_zero_plan(1, 3, flat)
    assert all(d is not None for d in plan.param_dims.values())
    assert plan.param_dims["layers/wq"] == 1        # [L, h, nh*hd]


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("dp", [1, 2, 8])
def test_estimate_zero_memory_matches_jax(stage, dp):
    n = 7_241_732_096
    assert tpart.estimate_zero_memory(n, stage, dp) == \
        jpart.estimate_zero_memory(n, stage, dp)


# ---------------------------------------------------------------------------
# the bucket plan
# ---------------------------------------------------------------------------
def _units_args():
    names = ["embed", "final_norm", "layers/a", "layers/b", "layers/c",
             "lm_head"]
    numels = [1000, 16, 4 * 300, 4 * 50, 2 * 700, 1000]
    kinds = [jgo.ALL_REDUCE, jgo.ALL_REDUCE, jgo.REDUCE_SCATTER,
             jgo.ALL_REDUCE, jgo.REDUCE_SCATTER, jgo.VJP]
    layers = [0, 0, 4, 4, 2, 0]
    stacked = [False, False, True, True, True, False]
    return names, numels, kinds, layers, stacked


@pytest.mark.parametrize("caps", [(1, 1), (400, 400), (1000, 300),
                                  (2000, 10 ** 9), (10 ** 9, 10 ** 9)])
def test_order_units_and_bucket_plan_match_jax(caps):
    args = _units_args()
    ref_units = jgo.order_units(*args)
    got_units = tgo.order_units(*args)
    assert [dataclasses.astuple(u) for u in got_units] == \
        [dataclasses.astuple(u) for u in ref_units]
    ref = jgo.build_bucket_plan(ref_units, *caps)
    got = tgo.build_bucket_plan(got_units, *caps)
    assert got.to_dict() == ref.to_dict()
    assert got.summary() == ref.summary()
    assert got.layout_key() == ref.layout_key()


def test_bucket_plan_rejects_nonpositive_caps():
    with pytest.raises(ValueError, match="must be > 0"):
        tgo.build_bucket_plan(tgo.order_units(*_units_args()), 0, 10)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_engine_bucket_plan_matches_jax_engine(stage):
    """The plan a port engine at world 2 would build against the JAX dp=2
    engine's own (its layer scan fully unrolled, so that its stacked
    leaves slice per layer as the port's layer loop always does)."""
    cfg = W.train_config(stage, mode="bucketed", threshold=1000)
    jeng = JEngine(JModel(JCfg(**W.FLAGSHIP_SMALL, scan_unroll=2)),
                   JDSConfig(cfg, world_size=2),
                   topology=JTopo(JTopoCfg(), devices=jax.devices()[:2]))
    ref = jeng.grad_bucket_plan.to_dict()
    _, flat = _jax_shapes()
    names = sorted(flat)
    zc = cfg["zero_optimization"]
    got = tgo.plan_grad_buckets(
        names, [flat[n] for n in names],
        tpart.build_zero_plan(2, stage, flat, persistence_threshold=1000
                              if stage == 3 else 0),
        zc["reduce_bucket_size"], zc["allgather_bucket_size"]).to_dict()

    def keystr(name):   # "['layers']['wq'][1]" -> "layers/wq[1]"
        return name.replace("']['", "/").replace("['", "").replace(
            "']", "")

    for b in ref["buckets"]:
        b["leaves"] = [keystr(n) for n in b["leaves"]]
    ref["vjp_leaves"] = [keystr(n) for n in ref["vjp_leaves"]]
    assert got == ref


# ---------------------------------------------------------------------------
# config, topology, comm surfaces
# ---------------------------------------------------------------------------
ADMITTED = [
    ({"zero_optimization": {"stage": 3}}, 1),
    ({"zero_optimization": {"stage": 2}}, 2),
    ({"zero_optimization": {"stage": 3, "reduce_bucket_size": 1000,
                            "allgather_bucket_size": 2000,
                            "overlap_grad_reduce": "bucketed",
                            "overlap_comm": False,
                            "stage3_param_persistence_threshold": 0}}, 4),
    ({"zero_optimization": {"stage": 1, "overlap_grad_reduce": "off"}}, 2),
]


@pytest.mark.parametrize("extra,world", ADMITTED)
def test_config_admits_zero_keys(extra, world):
    from deepspeed_tpu_torch.runtime.config import unported_keys

    cfg = dict(W.train_config(0), **extra)
    assert unported_keys(DeepSpeedConfig(cfg, world_size=world)) == []


REJECTED = [
    ({"zero_optimization": {"stage": 2, "offload_optimizer":
                            {"device": "cpu"}}}, 2, "A9"),
    ({"zero_optimization": {"stage": 3, "offload_param":
                            {"device": "cpu"}}}, 1, "A9"),
    ({"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
     2, "A10"),
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
     2, "A10"),
    ({"zero_optimization": {"stage": 3, "zero_quantized_gradients": True}},
     2, "A10"),
    ({"zero_optimization": {"stage": 2, "quantized_reduce": "int8"}},
     2, "A10"),
    ({"zero_optimization": {"stage": 3, "mics_shard_size": 2}}, 2, "A4"),
    ({"tensor_parallel_size": 2}, 2, "A8"),
]


@pytest.mark.parametrize("extra,world,item", REJECTED)
def test_config_rejects_unported_zero_keys(extra, world, item):
    from deepspeed_tpu_torch.runtime.config import check_ported

    cfg = dict(W.train_config(0), **extra)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        check_ported(DeepSpeedConfig(cfg, world_size=world))


@pytest.mark.parametrize("field,item", [
    ("model", "A8"), ("pipe", "A8"), ("seq", "A8"), ("expert", "A8"),
    ("mics_shard", "A4"), ("hpz_shard", "A10")])
def test_topology_raises_for_unported_axes(field, item):
    with pytest.raises(NotImplementedError, match=item):
        ttopo.MeshTopology(ttopo.TopologyConfig(**{field: 2}), world_size=4)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_topology_answers_like_jax(world):
    ref = JTopo(JTopoCfg(), devices=jax.devices()[:world])
    got = ttopo.MeshTopology(world_size=world, rank=world - 1)
    assert got.sizes == ref.sizes
    assert got.dp_axes == ref.dp_axes
    assert got.zero_shard_axes == ref.zero_shard_axes
    assert got.dp_world_size == ref.dp_world_size == world
    assert all(got.axis_size(a) == ref.axis_size(a) for a in ref.sizes)
    assert got.group(("data", "shard")) is None     # the default group


@pytest.mark.parametrize("name", ["tp_copy", "tp_reduce", "permute",
                                  "send_next", "send_prev", "recv_prev",
                                  "all_to_all_single"])
def test_unported_collectives_raise_a8(name):
    with pytest.raises(NotImplementedError, match="A8"):
        getattr(comm, name)(torch.zeros(2))


def test_model_axis_group_raises_a8():
    with pytest.raises(NotImplementedError, match="A8"):
        comm.all_reduce(torch.zeros(2), axis_name="model")


def test_quantized_gather_raises_a10():
    with pytest.raises(NotImplementedError, match="A10"):
        tq.make_zero3_gather(0, fwd_quantized=True)
    with pytest.raises(NotImplementedError, match="A10"):
        tgo.quant_reduce_layout()


def test_accelerators():
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.accelerator.cuda_accelerator import (
        CpuAccelerator, CudaAccelerator)

    assert CudaAccelerator().communication_backend_name() == "nccl"
    assert CudaAccelerator().device_name(1) == "cuda:1"
    cpu = CpuAccelerator()
    assert cpu.communication_backend_name() == "gloo"
    assert cpu.memory_stats()["bytes_limit"] > 0
    if not torch.cuda.is_available():
        assert isinstance(get_accelerator(), CpuAccelerator)


def test_timers_and_comms_logger():
    from deepspeed_tpu_torch.utils.comms_logging import calc_bw_log
    from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer

    timers = SynchronizedWallClockTimer(use_cuda=False)
    timers("step").start()
    sum(range(10000))
    timers("step").stop()
    assert timers.get_mean(["step"])["step"] > 0
    comm.configure(enabled=True)
    try:
        comm.all_reduce(torch.ones(256))
        rec = comm.get_comms_logger().comms_dict["all_reduce"]
        assert rec[1024][0] == 1
        assert "all_reduce" in comm.get_comms_logger().log_summary()
    finally:
        comm.configure(enabled=False)
    assert calc_bw_log("all_reduce", 1000, 1e-3, 2) == (2e-3, 1e-3)


# ---------------------------------------------------------------------------
# one rank: the sharded stages equal stage 0 bit for bit
# ---------------------------------------------------------------------------
def _engine(stage, mode, **model_kw):
    cfg = W.train_config(stage, mode=mode, bf16={"enabled": True})
    cfg["scheduler"] = None
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**W.FLAGSHIP_SMALL,
                                              **model_kw)),
        config={k: v for k, v in cfg.items() if v is not None},
        device="cpu", seed=3)
    return eng


@pytest.fixture(scope="module")
def stage0():
    eng = _engine(0, "off", remat=True)
    rng = np.random.default_rng(11)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 128))}
               for _ in range(3)]
    losses = [eng.train_batch(batch=b) for b in batches]
    return batches, losses, [p.detach().clone() for p in eng._param_leaves]


@pytest.mark.parametrize("mode", ["bucketed", "off"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_one_rank_stage_equals_stage0(stage0, stage, mode):
    batches, losses, params = stage0
    eng = _engine(stage, mode, remat=True)
    assert eng.grad_overlap_mode == mode
    assert [eng.train_batch(batch=b) for b in batches] == losses
    for p, q in zip(eng._param_leaves, params):
        assert torch.equal(p.detach(), q)


@pytest.mark.parametrize("remat", [True, False])
def test_stage3_gathers_each_layer_again_in_the_recompute(monkeypatch,
                                                          remat):
    eng = _engine(3, "off", remat=remat)
    calls = []
    real = tq.all_gather_leaf

    def counting(shard, dim, group=None):
        calls.append(tuple(shard.shape))
        return real(shard, dim, group)

    monkeypatch.setattr(tq, "all_gather_leaf", counting)
    rng = np.random.default_rng(12)
    eng.train_batch(batch={"input_ids": rng.integers(0, 256, (2, 2, 128))})
    L, gas = W.FLAGSHIP_SMALL["num_layers"], 2
    per_layer = sum(1 for n, d in zip(eng._leaf_names, eng._pdims)
                    if n.startswith("layers/") and d)
    whole = len(eng._whole_gathers)
    # the forward's gathers, the recompute's under remat; then the
    # publish of nothing (every compute leaf is its master's cast)
    want = gas * (whole + per_layer * L * (2 if remat else 1))
    assert len(calls) == want and per_layer > 0 and whole > 0

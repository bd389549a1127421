"""PyTorch port: the pipeline modules against the JAX package, on the CPU
without a process group.

* ``partition_balanced`` and the three partition methods (``uniform``,
  ``parameters``, ``type:regex``) against the JAX functions on the same
  layer lists (JAX ``tests/unit/pipe/test_pipeline_module.py:115,126``);
* the stacking plan ``{1: (1, 9, 2)}`` of the mixed list at pp 4 (:368)
  and the partition specs of stacked, replicated, tied and TP layers
  against JAX ``param_partition_specs``;
* the 1F1B tick table against the JAX schedule's arithmetic
  (``pipeline.py:215-258``), and a stage's in-flight micro-batches never
  above 2 pp - 1 at M 4 and M 32 (:166);
* ``TransformerLM.loss_and_grads`` through ``pipeline_1f1b`` at pp 1
  against autograd of the plain GAS loop (the engine's step) on the
  flagship small model, 1e-5, and against the JAX model's
  ``loss_and_grads`` on the same weights; ``PipelineModule`` the same way;
  with ``embed_scale`` != 1 against the port's own GAS loop (JAX's
  pipelined loss leaves the scale out);
* the pipe axis in the topology and ``comm`` at one rank, the refusals
  that need no process group, ``moe_layer_manual``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu import LayerSpec as JLayerSpec
from deepspeed_tpu import PipelineModule as JPipelineModule
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.parallel.topology import MeshTopology as JTopo
from deepspeed_tpu.parallel.topology import TopologyConfig as JTopoCfg
from deepspeed_tpu.runtime.pipe import module as jmod

from deepspeed_tpu_torch import LayerSpec, PipelineModule, TiedLayerSpec
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime.pipe import module as tmod
from deepspeed_tpu_torch.runtime.pipe import pipeline as tpipe

import test_torch_pipeline_distributed as D
import torch_pipe_dist_worker as W

torch.set_num_threads(2)

HID = 32
FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)


def _specs(tree):
    """A spec tree as {path: tuple of axis names} (JAX P -> tuple)."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = tuple(t)
    walk(tree, "")
    return out


# ---------------------------------------------------------------------------
# partitioning and storage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weights,parts", [
    ([1, 1, 1, 1], 2), ([100, 1, 1, 1], 2), ([1, 1], 4),
    ([3, 1, 4, 1, 5, 9, 2, 6], 3), ([0, 1, 0, 1], 2), ([2.5] * 7, 4)])
def test_partition_balanced_matches_jax(weights, parts):
    assert tmod.partition_balanced(weights, parts) == \
        jmod.partition_balanced(weights, parts)


def _pair(layers_fn, method):
    t = PipelineModule(layers_fn(W), W.mse_loss, partition_method=method)
    j = JPipelineModule(layers_fn(D), D._j_mse, partition_method=method)
    return t, j


def _big_first(mod):
    lin = mod.Linear if mod is W else mod.JLinear
    return [(tmod.LayerSpec if mod is W else JLayerSpec)(lin, 4 * HID,
                                                          4 * HID)] + \
        [(tmod.LayerSpec if mod is W else JLayerSpec)(lin, HID, HID)
         for _ in range(5)]


def _typed(mod):
    spec = tmod.LayerSpec if mod is W else JLayerSpec
    lin = mod.Linear if mod is W else mod.JLinear
    col = mod.ColParallelLinear if mod is W else mod.JCol
    return [spec(lin, HID, HID), spec(col, HID, HID), spec(lin, HID, HID),
            spec(col, HID, HID)]


@pytest.mark.parametrize("method,layers,pp", [
    ("uniform", _big_first, 4), ("parameters", _big_first, 2),
    ("type:Col", _typed, 2), ("parameters", _typed, 3)])
def test_partition_methods_match_jax(method, layers, pp):
    t, j = _pair(layers, method)
    assert t._layer_weights() == j._layer_weights()
    assert t.stage_bounds(pp) == j.stage_bounds(pp)


def test_unknown_partition_method_raises():
    with pytest.raises(ValueError, match="partition_method"):
        PipelineModule([LayerSpec(W.Linear, HID, HID)], W.mse_loss,
                       partition_method="bogus")._layer_weights()


def _mixed(mod):
    spec = tmod.LayerSpec if mod is W else JLayerSpec
    lin = mod.Linear if mod is W else mod.JLinear
    proj = mod.InProj if mod is W else mod.JInProj
    return ([spec(proj, HID, HID)] + [spec(lin, HID, HID) for _ in range(8)]
            + [spec(proj, HID, HID, act=False)])


def test_stack_plan_of_the_mixed_list():
    """JAX test_pipeline_module_mixed_stacked_and_replicated: the aligned
    run stacks, the distinct first and last layers stay replicated."""
    t, j = _pair(_mixed, "type:Linear$")   # JAX test: "type:^Linear$"
    assert t._stack_plan(4) == {1: (1, 9, 2)} == j._stack_plan(4)


@pytest.mark.parametrize("kind,pp,tp", [("pm_stacked", 4, 1),
                                        ("pm_tied", 4, 1), ("pm_tp", 2, 2),
                                        ("pm_sp", 2, 1)])
def test_partition_specs_match_jax(kind, pp, tp):
    """Each leaf's axes per dim, as JAX ``param_partition_specs`` states
    them, and the engine's cut dims derived from them."""
    sp = 2 if kind == "pm_sp" else 1
    t = PipelineModule(W.pm_layers(kind), W.mse_loss,
                       partition_method="uniform")
    j = JPipelineModule(D._j_layers(kind), D._j_mse,
                        partition_method="uniform")
    topo = ttopo.MeshTopology(ttopo.TopologyConfig(pipe=pp, model=tp,
                                                   seq=sp), world_size=4)
    jtopo = JTopo(JTopoCfg(pipe=pp, model=tp, seq=sp),
                  devices=jax.devices()[:4])
    t.set_topology(topo)
    j.set_topology(jtopo)
    got = _specs(t.param_partition_specs(topo))
    want = _specs(j.param_partition_specs(jtopo))
    assert got == want
    pipe = {k: v.index("pipe") for k, v in want.items() if "pipe" in v}
    model = {k: v.index("model") for k, v in want.items() if "model" in v}
    assert t.pipe_shard_dims == pipe and t.tp_shard_dims == model
    # the whole tree's shapes: stacked runs [pp * k, ...]
    jp = j.init_params(jax.random.PRNGKey(0))
    tp_ = t.init_params(torch.Generator().manual_seed(0))
    got_shapes = {k: tuple(v.shape) for k, v in tmod._leaves(tp_)}
    want_shapes = {"/".join(p.key for p in path): tuple(v.shape) for path, v
                   in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got_shapes == want_shapes


def test_transformer_pipe_dims_match_jax():
    """Every layer leaf of ``TransformerLM`` is cut over the pipe axis on
    its layer dimension (JAX ``param_partition_specs`` :487-530)."""
    cfg = dict(W.LM, moe_num_experts=4)
    jtopo = JTopo(JTopoCfg(pipe=2), devices=jax.devices()[:2])
    want = {k: v.index("pipe") for k, v in _specs(
        JModel(JCfg(**cfg)).param_partition_specs(jtopo)).items()
        if "pipe" in v}
    assert TransformerLM(TransformerConfig(**cfg)).pipe_shard_dims == want


# ---------------------------------------------------------------------------
# the 1F1B schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,pp", [(1, 1), (4, 1), (4, 2), (4, 4), (2, 4),
                                  (32, 4), (7, 3)])
def test_tick_table_matches_the_jax_arithmetic(M, pp):
    """JAX ``pipeline_1f1b``: T = M + 2 (pp - 1) ticks; forward slot
    m = t - s, backward slot m = t - 2 (pp - 1) + s, each active in
    [0, M); activations go s -> s + 1, cotangents s -> s - 1. The port's
    last stage runs its forward inside its backward slot (the same tick,
    the same micro-batch)."""
    table = tpipe.tick_table(M, pp)
    assert len(table) == M + 2 * (pp - 1)
    for t, row in enumerate(table):
        for s in range(pp):
            m_f, m_b = t - s, t - 2 * (pp - 1) + s
            f = m_f if 0 <= m_f < M else None
            b = m_b if 0 <= m_b < M else None
            assert row["forward"][s] == (f if s < pp - 1 else None)
            assert row["backward"][s] == b
            if s == pp - 1:
                assert b == f       # the last stage: one slot, one tick
        sends = {(a, d, k) for a, d, k, _ in row["sends"]}
        want = {(s, s + 1, "act") for s in range(pp - 1)
                if 0 <= t - s < M}
        want |= {(s, s - 1, "grad") for s in range(1, pp)
                 if 0 <= t - 2 * (pp - 1) + s < M}
        assert sends == want
    # every micro-batch runs forward and backward once on every stage
    for s in range(pp):
        bwd = [r["backward"][s] for r in table if r["backward"][s] is not None]
        assert bwd == list(range(M))
        if s < pp - 1:
            fwd = [r["forward"][s] for r in table
                   if r["forward"][s] is not None]
            assert fwd == list(range(M))


@pytest.mark.parametrize("M", [4, 32])
@pytest.mark.parametrize("pp", [2, 4])
def test_in_flight_is_bounded_by_2pp_minus_1(M, pp):
    """A stage holds a micro-batch from its forward slot to its backward
    slot: never more than K = 2 pp - 1 (JAX's stash depth), whatever M
    (JAX test_pipeline_module_1f1b_bounded_stash)."""
    table = tpipe.tick_table(M, pp)
    for s in range(pp):
        held, most = set(), 0
        for row in table:
            f, b = row["forward"][s], row["backward"][s]
            if f is not None:
                held.add(f)
            if s == pp - 1 and b is not None:
                held.add(b)     # the last stage's one slot
            most = max(most, len(held))
            if b is not None:
                held.discard(b)
        assert most == min(M, 2 * (pp - 1 - s) + 1) <= 2 * pp - 1


def _tree_requires_grad(tree):
    return {k: _tree_requires_grad(v) if isinstance(v, dict)
            else v.clone().requires_grad_(True) for k, v in tree.items()}


def _flat_np(tree):
    return {k: v.detach().numpy() for k, v in tpipe._flatten(tree)}


@pytest.fixture(scope="module")
def flagship():
    """The flagship small model's JAX-initialized weights, a [M=3, 2, 128]
    batch and the JAX ``loss_and_grads`` at pp 1 on them."""
    jm = JModel(JCfg(**FLAGSHIP_SMALL))
    jm.set_topology(JTopo(JTopoCfg(), devices=jax.devices()[:1]))
    w = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    ids = np.random.default_rng(5).integers(0, 256, (3, 2, 128))
    loss, grads = jax.jit(jm.loss_and_grads)(w, {"input_ids": ids})
    jg = {"/".join(p.key for p in path): np.asarray(v) for path, v in
          jax.tree_util.tree_flatten_with_path(grads)[0]}
    return w, ids, float(loss), jg


def test_1f1b_at_pp1_matches_the_gas_loop_and_jax(flagship):
    """``loss_and_grads`` through ``pipeline_1f1b`` at pp 1 against
    autograd of the plain GAS loop (what the engine's step computes) and
    against the JAX model's ``loss_and_grads``, on the same weights."""
    w, ids, jloss, jgrads = flagship
    model = TransformerLM(TransformerConfig(**FLAGSHIP_SMALL))
    model.set_topology(ttopo.MeshTopology(world_size=1, rank=0))
    params = _tree_requires_grad(params_from_numpy(w))
    tids = torch.as_tensor(ids)
    loss, grads = model.loss_and_grads(params, {"input_ids": tids})
    got = _flat_np(grads)
    # the GAS loop: the mean of the micro-batches' losses and gradients
    leaves = [v for _, v in tpipe._flatten(params)]
    losses, acc = [], None
    for m in range(ids.shape[0]):
        lm = model.apply(params, {"input_ids": tids[m]})
        g = torch.autograd.grad(lm, leaves)
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        losses.append(float(lm.detach()))
    np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-5)
    for (k, _), a in zip(tpipe._flatten(params), acc):
        np.testing.assert_allclose(got[k], (a / 3).numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for k, v in jgrads.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)


def test_1f1b_applies_embed_scale_like_the_engine_step(flagship):
    """``embed_scale`` != 1 (Gemma's sqrt(H)): the pipelined loss (the
    1F1B schedule's stage code, whose stage 0 embeds at every pp) equals
    the port's own GAS loop (``apply``, the pp-1 engine step) on the same
    weights, 1e-5. This departs from the JAX package on purpose: its
    pipelined ``loss_and_grads`` leaves the scale out
    (``deepspeed_tpu/models/transformer.py:921``, ``x0 =
    pp_["embed"][ids_mb]``) while its own pp-1 forward applies it
    (:711-712), so there JAX's pipelined loss differs from its pp-1
    loss, and it is not an oracle for this case."""
    w, ids, _, _ = flagship
    model = TransformerLM(TransformerConfig(**dict(FLAGSHIP_SMALL,
                                                   embed_scale=2.0)))
    model.set_topology(ttopo.MeshTopology(world_size=1, rank=0))
    params = _tree_requires_grad(params_from_numpy(w))
    tids = torch.as_tensor(ids)
    loss, grads = model.loss_and_grads(params, {"input_ids": tids})
    got = _flat_np(grads)
    leaves = [v for _, v in tpipe._flatten(params)]
    losses, acc = [], None
    for m in range(ids.shape[0]):
        lm = model.apply(params, {"input_ids": tids[m]})
        g = torch.autograd.grad(lm, leaves)
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        losses.append(float(lm.detach()))
    np.testing.assert_allclose(float(loss), np.mean(losses), rtol=1e-5)
    for (k, _), a in zip(tpipe._flatten(params), acc):
        np.testing.assert_allclose(got[k], (a / 3).numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the scale is in the loss: unscaled, the same weights give another
    plain = TransformerLM(TransformerConfig(**FLAGSHIP_SMALL))
    with torch.no_grad():
        unscaled = float(plain.apply(params, {"input_ids": tids[0]}))
    assert abs(unscaled - losses[0]) > 1e-3


def test_1f1b_accumulates_into_the_callers_buffers(flagship):
    """``grad_acc`` (the engine's f32 buffers): the schedule zeroes them,
    adds into them and returns them as the gradients, equal to the ones
    it allocates itself; a list that does not match the leaves raises."""
    w, ids, _, _ = flagship
    model = TransformerLM(TransformerConfig(**FLAGSHIP_SMALL))
    model.set_topology(ttopo.MeshTopology(world_size=1, rank=0))
    params = _tree_requires_grad(params_from_numpy(w))
    batch = {"input_ids": torch.as_tensor(ids)}
    loss, own = model.loss_and_grads(params, batch)
    bufs = [torch.full(v.shape, 7.0) for _, v in tpipe._flatten(params)]
    loss2, grads = model.loss_and_grads(params, batch, grad_acc=bufs)
    assert float(loss2) == float(loss)
    for b, (k, g), (_, o) in zip(bufs, tpipe._flatten(grads),
                                 tpipe._flatten(own)):
        assert g is b, k
        assert torch.equal(g, o), k
    with pytest.raises(ValueError, match="grad_acc"):
        model.loss_and_grads(params, batch, grad_acc=bufs[:-1])


@pytest.mark.parametrize("kind", ["pm_tied", "pm_stacked"])
def test_pipeline_module_pp1_matches_jax(kind):
    """``PipelineModule.loss_and_grads`` at pp 1 (the same schedule)
    against the JAX module's, and ``apply`` against JAX's ``apply``."""
    j = JPipelineModule(D._j_layers(kind), D._j_mse,
                        partition_method="uniform", input_ndim=2)
    j.set_topology(JTopo(JTopoCfg(), devices=jax.devices()[:1]))
    t = PipelineModule(W.pm_layers(kind), W.mse_loss,
                       partition_method="uniform", input_ndim=2)
    t.set_topology(ttopo.MeshTopology(world_size=1, rank=0))
    w = jax.tree.map(np.asarray, j.init_params(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    batch = {"x": rng.standard_normal((4, 3, HID)).astype(np.float32),
             "y": rng.standard_normal((4, 3, HID)).astype(np.float32)}
    jloss, jgrads = jax.jit(j.loss_and_grads)(w, batch)
    params = _tree_requires_grad(params_from_numpy(w))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, grads = t.loss_and_grads(params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _flat_np(grads)
    for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        k = "/".join(p.key for p in path)
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-5,
                                   err_msg=k)
    with torch.no_grad():
        np.testing.assert_allclose(float(t.apply(params, tb)),
                                   float(j.apply(w, batch)), rtol=1e-5)
    # one micro-batch (the engine's GAS loop at pp 1): input_ndim adds M
    with torch.no_grad():
        one = float(t.apply(params, {k: v[0] for k, v in tb.items()}))
    np.testing.assert_allclose(one, float(j.apply(
        w, {k: v[0] for k, v in batch.items()})), rtol=1e-5)


# ---------------------------------------------------------------------------
# topology, comm, refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipe,model,expert", [(2, 1, 1), (4, 1, 1),
                                               (2, 2, 1), (2, 1, 2)])
def test_topology_with_a_pipe_axis_matches_jax(pipe, model, expert):
    """The pipe axis is outermost and never a data axis: sizes, dp / batch
    axes, dp world, and rank r's coordinates are JAX device r's."""
    ref = JTopo(JTopoCfg(pipe=pipe, model=model, expert=expert),
                devices=jax.devices()[:4])
    for r in range(4):
        got = ttopo.MeshTopology(ttopo.TopologyConfig(
            pipe=pipe, model=model, expert=expert), world_size=4, rank=r)
        assert got.sizes == ref.sizes
        assert got.dp_axes == ref.dp_axes
        assert got.batch_axes == ref.batch_axes
        assert got.zero_shard_axes == ref.zero_shard_axes
        assert got.dp_world_size == ref.dp_world_size
        where = np.argwhere(np.vectorize(lambda d: d.id)(ref.mesh.devices)
                            == jax.devices()[r].id)[0]
        assert tuple(got.coords[a] for a in ttopo.AXIS_ORDER) == \
            tuple(int(i) for i in where)
        assert got.pp_rank == got.coords["pipe"] and got.pp_size == pipe
    with pytest.raises(ValueError, match="pipe\\*model\\*seq\\*expert"):
        ttopo.MeshTopology(ttopo.TopologyConfig(pipe=3), world_size=4)


def test_permute_over_the_pipe_axis_at_one_rank():
    x = torch.arange(4.0)
    assert torch.equal(comm.permute(x, [(0, 0)]), x)
    assert torch.equal(comm.send_next(x), x)
    assert torch.equal(comm.permute(x, [(0, 1)]), torch.zeros(4))
    comm.exchange([], [])       # nothing to move
    tok = torch.zeros((), requires_grad=True)
    xg = x.clone().requires_grad_(True)
    y, tok2 = comm.permute_grad(xg, [(0, 0)], tok)
    (y.sum() * 2 + tok2).backward()
    assert torch.equal(xg.grad, torch.full((4,), 2.0))
    assert float(tok.grad) == 1.0


def _engine(net, extra, world=4, pipe=2, **topo):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine

    cfg = {"train_micro_batch_size_per_gpu": 1, "pipeline": {"stages": pipe},
           "steps_per_print": 10 ** 9, **extra}
    return DeepSpeedTpuEngine(
        net, DeepSpeedConfig(cfg, world_size=world), device="cpu",
        topology=ttopo.MeshTopology(ttopo.TopologyConfig(pipe=pipe, **topo),
                                    world_size=world, rank=0))


@pytest.mark.parametrize("topo,extra,match", [
    (dict(model=2), {"tensor_parallel_size": 2}, "pp_manual_axes"),
    (dict(seq=2), {"sequence_parallel_size": 2}, "'seq' in pp_manual_axes"),
    ({}, {"zero_optimization": {"stage": 2}}, "ZeRO stage <= 1"),
])
def test_transformer_pipeline_refusals(topo, extra, match):
    """TransformerLM declares no manual TP or seq axis (JAX :1015-1030);
    ZeRO 2 / 3 refuse the pipeline (reference PipelineEngine)."""
    with pytest.raises(AssertionError, match=match):
        _engine(TransformerLM(TransformerConfig(**W.LM)), extra, **topo)


def test_pipeline_refuses_param_offload_and_pp_x_ep_without_support():
    with pytest.raises(NotImplementedError, match="offload_param"):
        _engine(TransformerLM(TransformerConfig(**W.LM)),
                {"zero_optimization": {"stage": 1, "offload_param":
                                       {"device": "cpu"}}})

    class NoEp(TransformerLM):
        supports_pp_ep = False

    with pytest.raises(AssertionError, match="supports_pp_ep"):
        _engine(NoEp(TransformerConfig(**W.LM, **W.MOE)),
                {"moe": {"enabled": True, "num_experts": 4,
                         "expert_parallel_size": 2}}, expert=2)


def test_dropless_moe_at_pp_x_ep_raises():
    """JAX :655-660: dropless routing inside the manual pipeline program
    at ep > 1 is refused (before any collective)."""
    from deepspeed_tpu_torch.moe.sharded_moe import MoEGroups

    cfg = TransformerConfig(**W.LM, **dict(W.MOE, moe_dropless=True))
    model = TransformerLM(cfg)
    p = model.init_params(torch.Generator().manual_seed(0))
    lp = {k: v[0] for k, v in p["layers"].items()}
    model.moe_groups = MoEGroups(None, 1, 0, None, 2, 0)
    model._inside_manual_pipe = True
    with pytest.raises(NotImplementedError, match="pp x ep"):
        model._moe(lp, torch.zeros(1, 4, cfg.hidden_size))


def test_moe_layer_manual_at_ep1_is_the_local_moe_layer():
    """At ep 1 the manual dispatch is the capacity layer with the gating
    local to this rank's tokens: the JAX ``moe_layer`` (jitted) on the
    same inputs."""
    from deepspeed_tpu.moe import sharded_moe as jmoe
    from deepspeed_tpu_torch.moe import sharded_moe as tmoe

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    gate = rng.standard_normal((32, 4)).astype(np.float32) * 0.5
    ex = tuple(rng.standard_normal(s).astype(np.float32) * 0.1
               for s in ((4, 32, 64), (4, 32, 64), (4, 64, 32)))

    def jfn(p, xe):
        wg, wu, wd = p
        return (jax.nn.silu(xe @ wg) * (xe @ wu)) @ wd

    want, waux = jax.jit(lambda *a: jmoe.moe_layer(
        a[0], a[1], a[2], jfn, None, top_k=2, capacity_factor=1.0))(
        x, gate, ex)
    got, aux = tmoe.moe_layer_manual(
        torch.as_tensor(x), torch.as_tensor(gate),
        tuple(torch.as_tensor(e) for e in ex), tmoe.swiglu_experts,
        None, top_k=2, capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_tied_layer_spec_and_exports():
    spec = TiedLayerSpec("proj", W.InProj, HID, HID, forward_fn=W.head_fwd)
    assert spec.key == "proj" and spec.type_name == "InProj"
    assert isinstance(spec.build(), W.InProj)
    import deepspeed_tpu_torch
    assert deepspeed_tpu_torch.PipelineModule is tmod.PipelineModule

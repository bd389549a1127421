"""PyTorch port: the tensor-parallel plan, the vocab-parallel loss, ring
attention and the safe-mode scan, in one process, against the JAX package.

* ``models/transformer.tp_shard_dims`` against JAX ``param_partition_specs``
  at a model axis of 2: the same leaves, each cut on the same dimension
  (dense, MoE with a residual branch, biased GELU and tied configs);
* the vocab-parallel chunked cross-entropy at one rank against JAX
  ``_chunked_ce_loss``, its value and its gradients;
* ``sequence/ring_attention.ring_attention`` over a one-rank seq group,
  sub-blocked (``q_chunk`` / ``kv_chunk``), against JAX ``ring_attention``
  in a one-device ``shard_map`` and ``mha_reference``, forward and
  gradients within 2e-5 (JAX ``test_ring_attention.py:106,128``);
* ``utils/sanity.find_nonfinite``'s reports equal to JAX's;
* the parallel compositions the port refuses, each naming its ROADMAP
  item;
* an engine at one rank with every new key at its one-rank value
  (``tensor_parallel_size`` / ``sequence_parallel_size`` /
  ``mics_shard_size`` 1, ``reduce_scatter: false``) ``torch.equal`` to the
  plain stage-3 engine.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops.flash_attention import mha_reference as jmha
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.sequence.ring_attention import ring_attention as jring
from deepspeed_tpu.utils import sanity as jsanity

from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models import transformer as ttr
from deepspeed_tpu_torch.ops.flash_attention import mha_reference as tmha
from deepspeed_tpu_torch.sequence.ring_attention import ring_attention
from deepspeed_tpu_torch.utils import sanity as tsanity

torch.set_num_threads(2)

SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_layers=2, num_heads=8, num_kv_heads=4, max_seq_len=128)
CONFIGS = {
    "dense": {},
    "moe_residual": dict(moe_num_experts=4, moe_top_k=2,
                         moe_use_residual=True),
    "biased_gelu": dict(activation="gelu", mlp_bias=True, attn_bias=True,
                        lm_head_bias=True),
    "tied": dict(tie_embeddings=True),
}


def _model_dims(specs):
    """{path: index of "model" in the leaf's spec, or None}."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in flat:
        key = "/".join(k.key for k in path)
        dims = [i for i, a in enumerate(spec) if a == "model"
                or (isinstance(a, tuple) and "model" in a)]
        out[key] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_plan_matches_jax_specs(name):
    cfg = dict(SMALL, **CONFIGS[name])
    topo = MeshTopology(TopologyConfig(model=2), devices=jax.devices()[:2])
    want = _model_dims(JModel(JCfg(**cfg)).param_partition_specs(topo))
    got = ttr.tp_shard_dims(TransformerConfig(**cfg))
    assert got == want
    # the plan names every leaf of the parameter tree
    from deepspeed_tpu_torch.runtime.engine import _flatten
    tree = TransformerLM(TransformerConfig(**cfg)).init_params(
        torch.Generator().manual_seed(0))
    assert sorted(k for k, _ in _flatten(tree)) == sorted(got)


def test_tp_refuses_uneven_heads():
    with pytest.raises(NotImplementedError, match="A8"):
        ttr.check_tp(TransformerConfig(**SMALL), 8)     # 4 kv heads


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jax_tp4_loss(model_cfg):
    """One step of the JAX engine at tp 4 on 4 virtual devices."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
    from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine

    cfg = {"train_micro_batch_size_per_gpu": 1,
           "tensor_parallel_size": 4, "zero_optimization": {"stage": 0},
           "steps_per_print": 10 ** 9}
    ids = np.random.default_rng(0).integers(0, 128, (1, 1, 32))
    jeng = JEngine(JModel(JCfg(**model_cfg)), JDSConfig(cfg, world_size=4),
                   topology=MeshTopology(TopologyConfig(model=4),
                                         devices=jax.devices()[:4]))
    return float(jeng.train_batch(batch={"input_ids": ids}))


UNEVEN_TP4 = dict(SMALL, num_heads=4, num_kv_heads=4, hidden_size=64)


def test_jax_trains_even_tp4():
    """The control of ``test_jax_refuses_uneven_tp_too``: the same model
    with every sharded count divisible by 4 takes a step at tp 4."""
    assert np.isfinite(_jax_tp4_loss(UNEVEN_TP4))


@pytest.mark.parametrize("field,where", [
    pytest.param(dict(num_kv_heads=2), r"shard_map .* not evenly divisible",
                 id="field0"),
    pytest.param(dict(vocab_size=130),
                 r"pjit outputs .*\['embed'\].* divisible by 4", id="field1"),
    pytest.param(dict(intermediate_size=190),
                 r"pjit outputs .*\['w_down'\].* divisible by 4",
                 id="field2")])
def test_jax_refuses_uneven_tp_too(field, where):
    """The JAX engine at tp 4 on 4 virtual devices refuses an uneven split
    of the kv heads (in the attention's ``shard_map``), the vocabulary or
    the FFN width (in its state's output shardings) with a ``ValueError``:
    there is no JAX run of a padded layout to hold the port to, and the
    port refuses the split before any collective runs."""
    with pytest.raises(ValueError, match=where):
        _jax_tp4_loss(dict(UNEVEN_TP4, **field))
    from deepspeed_tpu_torch.parallel import topology as ttopo
    with pytest.raises(NotImplementedError, match="A8"):
        TransformerLM(TransformerConfig(**dict(UNEVEN_TP4, **field))).set_topology(
            ttopo.MeshTopology(ttopo.TopologyConfig(model=4), world_size=4,
                               rank=0))


def test_vocab_parallel_loss_at_tp1_matches_jax():
    B, S, H, V, chunk = 2, 40, 32, 96, 16
    x, head = _rand(0, (B, S, H)), _rand(1, (H, V), 0.3)
    tgt = np.random.default_rng(2).integers(0, V, (B, S))
    mask = (np.random.default_rng(3).random((B, S)) > 0.2).astype(np.float32)

    def jloss(x, head):
        total, count = jtr._chunked_ce_loss(x, jnp.asarray(tgt),
                                            jnp.asarray(mask), head, chunk)
        return total / count

    jl, (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(head, requires_grad=True)
    total, count = ttr._vocab_parallel_ce_loss(
        tx, torch.tensor(tgt), torch.tensor(mask), th, chunk, 0, None)
    tl = total / count
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=0,
                               atol=1e-6)
    # and the port's own whole-vocab loss, the tp-1 path of apply()
    t2, c2 = ttr._chunked_ce_loss(torch.tensor(x), torch.tensor(tgt),
                                  torch.tensor(mask), torch.tensor(head),
                                  chunk)
    np.testing.assert_allclose((t2 / c2).item(), tl.item(), rtol=1e-6)


def _qkv(s, h=4, hkv=2, d=8, b=1):
    return (_rand(10, (b, h, s, d)), _rand(11, (b, hkv, s, d)),
            _rand(12, (b, hkv, s, d)))


def _jax_ring(q_chunk, kv_chunk, causal):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    spec = P(None, None, "seq", None)
    return shard_map(partial(jring, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk),
                     mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, check_rep=False)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_at_one_rank_matches_jax(causal):
    q, k, v = _qkv(128)
    want = _jax_ring(8, 16, causal)(q, k, v)
    ref = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = ring_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         causal=causal, q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    plain = tmha(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                 causal=causal)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_ring_grads_at_one_rank_match_jax():
    q, k, v = _qkv(64)
    fn = _jax_ring(8, 8, True)
    jg = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2),
                  argnums=(0, 1, 2))(q, k, v)
    jr = jax.grad(lambda q, k, v: jnp.sum(jmha(q, k, v, causal=True) ** 2),
                  argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (ring_attention(tq, tk, tv, causal=True, q_chunk=8, kv_chunk=8) ** 2
     ).sum().backward()
    for t, a, b in zip((tq, tk, tv), jg, jr):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), rtol=3e-5,
                                   atol=3e-5)


def test_ring_warns_on_a_chunk_that_does_not_divide(caplog):
    q, k, v = (torch.tensor(a) for a in _qkv(64))
    with caplog.at_level("WARNING"):
        out = ring_attention(q, k, v, q_chunk=24)
    assert "does not divide" in caplog.text
    np.testing.assert_allclose(out.numpy(),
                               tmha(q, k, v, causal=True).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_find_nonfinite_matches_jax():
    tree = {"embed": _rand(20, (4, 3)),
            "layers": {"wq": _rand(21, (2, 3, 3)), "wk": _rand(22, (2, 3))},
            "step": np.arange(3, dtype=np.int32)}
    tree["embed"][1, 2] = np.nan
    tree["layers"]["wq"][0, 0, :2] = np.inf
    want = jsanity.find_nonfinite(tree, "params")
    assert len(want) == 2
    assert tsanity.find_nonfinite(tree, "params") == want
    as_torch = jax.tree.map(torch.from_numpy, tree)
    assert tsanity.find_nonfinite(as_torch, "params") == want
    assert tsanity.find_nonfinite({"w": torch.ones(2)}) == []


def test_one_rank_parallel_keys_are_the_plain_engine():
    """tensor / sequence / MiCS at 1 and reduce_scatter off: the engine is
    the plain stage-3 one bit for bit (what phase 8h checks on the card)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils.sanity import check_engine_sanity

    model_cfg = dict(SMALL, flash_min_seq=128)
    base = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 3,
                                  "stage3_param_persistence_threshold": 0},
            "steps_per_print": 10 ** 9, "telemetry": {"enabled": False}}
    new = dict(base, tensor_parallel_size=1, sequence_parallel_size=1,
               zero_optimization=dict(base["zero_optimization"],
                                      mics_shard_size=1,
                                      reduce_scatter=False))
    batch = {"input_ids": np.random.default_rng(5).integers(
        0, 256, (2, 2, 128), dtype=np.int64)}
    out = []
    for cfg in (base, new):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=TransformerLM(TransformerConfig(**model_cfg)), config=cfg,
            device="cpu")
        losses = [eng.train_batch(batch=batch) for _ in range(2)]
        out.append((losses, [p.detach().clone()
                             for p in eng._param_leaves]))
        assert check_engine_sanity(eng) == {"ok": True, "problems": []}
        eng.close()
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("topo,extra,item", [
    (dict(seq=2, mics_shard=2), {"sequence_parallel_size": 2,
                                  "zero_optimization": {
                                      "stage": 3, "mics_shard_size": 2}},
     "A8"),
    (dict(model=2, expert=2), {"tensor_parallel_size": 2,
                               "moe": {"enabled": True, "num_experts": 4,
                                       "expert_parallel_size": 2}}, "A8"),
    (dict(model=2), {"tensor_parallel_size": 2, "zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"}}}, "A9"),
])
def test_parallel_compositions_not_ported_raise(topo, extra, item):
    """Compositions the port once refused, each named by its ROADMAP
    item, now build at world 4 (a topology of 4 ranks, built without a
    group; no collective runs in the build)."""
    from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                       TopologyConfig)
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine

    cfg = {"train_micro_batch_size_per_gpu": 1,
           "zero_optimization": {"stage": 1}, **extra}
    model_cfg = dict(SMALL, moe_num_experts=4) if "moe" in extra else SMALL

    def build():
        return DeepSpeedTpuEngine(
            TransformerLM(TransformerConfig(**model_cfg)),
            DeepSpeedConfig(cfg, world_size=4), device="cpu",
            topology=MeshTopology(TopologyConfig(**topo), world_size=4,
                                  rank=0))

    if item == "A8":
        # ported now (tests/test_torch_expert_zero_distributed.py trains
        # both against JAX at world 4): MiCS x sp shards over the MiCS
        # group, its gradients averaged over the data x seq replicas; tp x
        # ep holds 2 of the 4 experts, each cut on F by tp
        eng = build()
        if "mics_shard_size" in str(extra):
            assert eng.zero_world == 2
            assert {k: n for k, (_, n) in eng._replica.items()} == \
                {False: 2, True: 2}
        else:
            lp = eng.params["layers"]
            assert tuple(lp["e_up"].shape) == (2, 2, 128, 128)
            assert tuple(lp["wq"].shape) == (2, 128, 64)
            assert eng._expert_zero[1] == 1
        return
    # A9: the offload tiers at tp > 1 run now
    # (tests/test_torch_tiers_distributed.py trains them against JAX at
    # world 4): the host tier holds the data shard of the rank's slice
    eng = build()
    master = dict(zip(eng._leaf_names, eng.host_opt.get_all_leaves()[0]))
    assert tuple(eng.params["layers"]["wq"].shape) == (2, 128, 64)
    assert tuple(master["layers/wq"].shape) == (2, 64, 64)
    eng.close()


def test_send_next_of_a_list_at_one_rank():
    """The ring's shift takes a list of tensors (one batch_isend_irecv at
    N ranks; ``test_torch_tensor_parallel.py`` runs it at sp 2): at one
    rank each comes back as a copy of itself."""
    from deepspeed_tpu_torch.comm import comm

    a, b = torch.arange(3.0), torch.ones(2, 2)
    got = comm.send_next([a, b], "seq")
    assert len(got) == 2 and got[0] is not a
    assert torch.equal(got[0], a) and torch.equal(got[1], b)
    assert torch.equal(comm.send_prev(a, "seq"), a)

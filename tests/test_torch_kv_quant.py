"""PyTorch port: the int8 KV pool (``kv_quant``) against the JAX package.

The same numpy inputs and the same weights (initialized by the JAX package,
moved by name through ``params_from_numpy``) go through ``deepspeed_tpu``
and ``deepspeed_tpu_torch`` on the CPU, in fp32 unless stated; the JAX
Pallas kernels run in interpret mode, as the JAX tests run them. Held
equal:

* ``_kv_write`` under ``kv_quant``: the int8 pool and its per-(block, kv
  head) scales bit-identical outside the null block 0, in bf16 and fp32,
  over write-sets with and without scale growth, duplicate blocks (a chunk
  spanning a block), fresh blocks and padding to block 0. The port
  requantizes the write-set's distinct blocks unconditionally; JAX does it
  under a ``lax.cond`` on any scale growing. These tests pin that the two
  agree bit for bit;
* the plain int8 paged and ragged attention against the JAX quant kernels
  (2e-5), and a pure-decode int8 ragged batch equal to int8 paged decode;
* a ``kv_quant`` engine against the JAX ``kv_quant`` engine: put() logits
  (2e-4), greedy generate() streams at decode windows 1 and 8 and
  SplitFuse scheduler streams token-identical, the pool's leaves, dtypes
  and bytes equal.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.v2 import DynamicSplitFuseScheduler as JSched
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2 import paged_model as jpm
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.kernels.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu.inference.v2.kernels.ragged_attention import \
    ragged_attention as jax_ragged_attention
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models.transformer import tiny_test as jax_tiny_test

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2 import paged_model as tpm
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import (
    check_kernel_args, paged_attention, paged_attention_plain)
from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import (
    ragged_attention, ragged_attention_plain)
from deepspeed_tpu_torch.inference.v2.ragged import batch as tbatch
from deepspeed_tpu_torch.inference.v2.ragged.ragged_manager import \
    DSStateManager
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

BS = 16
SM = dict(max_tracked_sequences=8, max_seq_len=128, num_blocks=65,
          block_size=BS)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    """tiny_test widths (hidden 128, 2 layers), 4 q heads over 2 kv heads."""
    jcfg = dataclasses.replace(jax_tiny_test(), num_kv_heads=2)
    jmodel = JModel(jcfg)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    return jmodel, np_params, tmodel, params_from_numpy(np_params)


def _jax_engine(models, window):
    jmodel, np_params, _, _ = models
    return JEngine(jmodel, JConfig(state_manager=JSM(**SM), dtype="float32",
                                   prefill_bucket=16, decode_window=window,
                                   kv_quant=True),
                   params=np_params)


def _torch_engine(models, window, **kw):
    _, _, tmodel, tparams = models
    return InferenceEngineV2(
        tmodel, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(**SM), dtype="float32",
            prefill_bucket=16, decode_window=window, kv_quant=True, **kw),
        params=tparams, device="cpu")


@pytest.fixture(scope="module")
def jax_engines(models):
    return {w: _jax_engine(models, w) for w in (1, 8)}


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lengths]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# _kv_write: bit-identical to JAX outside the null block
# ---------------------------------------------------------------------------
def _write_sets():
    """(blocks, offsets, magnitude) of successive write-sets into one pool
    of 10 blocks x 16 slots; padding tokens target block 0, slot 0."""
    def ws(pairs, mag, pad=0):
        blocks = [b for b, _ in pairs] + [0] * pad
        offs = [o for _, o in pairs] + [0] * pad
        return np.array(blocks, np.int32), np.array(offs, np.int32), mag

    return [
        # a 20-token prefill chunk spanning fresh blocks 1 and 2 (duplicate
        # block indices), padded to 24
        ws([(1, o) for o in range(16)] + [(2, o) for o in range(4)], 1.0,
           pad=4),
        # small values into block 2: no scale grows
        ws([(2, 4), (2, 5)], 0.1, pad=2),
        # large values into block 2: its scale grows, its six earlier
        # tokens are requantized
        ws([(2, 6), (2, 7), (2, 8)], 4.0, pad=1),
        # a chunk finishing block 2 (same magnitude as the block holds:
        # growth in some heads at most) and filling fresh blocks 3 and 4
        ws([(2, o) for o in range(9, 16)] + [(3, o) for o in range(16)]
           + [(4, 0)], 4.0, pad=8),
        # decode rows: each live row writes its own block, inactive rows
        # the null block; block 4 grows, block 3 is full and untouched
        ws([(4, 1), (5, 0)], 8.0, pad=2),
        # a decode step that grows nothing
        ws([(4, 2), (5, 1)], 0.5, pad=2),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_write_bit_identical_to_jax(models, dtype):
    jmodel, _, tmodel, _ = models
    cfg_j, cfg_t = jmodel.cfg, tmodel.cfg
    nb, kvh, hd, L = 10, cfg_t.kv_heads, cfg_t.head_dim, cfg_t.num_layers
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jc = jpm.init_paged_kv_cache(cfg_j, nb, BS, jdt, kv_quant=True)
    tc = tpm.init_paged_kv_cache(cfg_t, nb, BS, tdt, "cpu", kv_quant=True)
    # the engine runs _kv_write inside its compiled step: compile it here
    # too (XLA turns `/ 127.0` into a multiply by the f32 reciprocal)
    jwrite = jax.jit(jpm._kv_write, static_argnums=2)
    rng = np.random.default_rng(0)
    grew = 0
    for blocks, offs, mag in _write_sets():
        touched = np.unique(blocks)
        touched = np.pad(touched, (0, 8 - len(touched)))   # null padded
        for l in range(L):
            x = (mag * rng.normal(size=(len(blocks), kvh, hd))).astype(
                np.float32)
            xj = jnp.asarray(x, jdt)
            xt = torch.from_numpy(x).to(tdt)
            before = np.asarray(jc["ks"][l]).copy()
            for key, skey, val_j, val_t in (("k", "ks", xj, xt),
                                            ("v", "vs", -xj, -xt)):
                jc[key], jc[skey] = jwrite(jc[key], jc[skey], l,
                                           jnp.asarray(blocks),
                                           jnp.asarray(offs), val_j)
                tpm._kv_write(tc[key], tc[skey], l,
                              torch.from_numpy(blocks).long(),
                              torch.from_numpy(offs).long(), val_t,
                              torch.from_numpy(touched).long())
            grew += int((np.asarray(jc["ks"][l])[1:] > before[1:]).any())
        for key in ("k", "v", "ks", "vs"):
            assert tc[key].dtype == {"k": torch.int8, "v": torch.int8}.get(
                key, torch.float32)
            np.testing.assert_array_equal(tc[key][:, 1:].numpy(),
                                          np.asarray(jc[key])[:, 1:],
                                          err_msg=key)
    assert 0 < grew < len(_write_sets()) * L       # growth and no growth
    assert (tc["ks"][:, 6:] == 0).all()            # untouched blocks


def test_requant_of_an_unchanged_block_is_the_identity():
    """The unconditional requant's claim: ratio exactly 1.0 where a scale
    did not grow, and round(q * 1.0) == q for every int8 value."""
    q = torch.arange(-127, 128, dtype=torch.int8)
    s = torch.tensor(0.0371, dtype=torch.float32)
    ratio = s / s
    assert ratio.item() == 1.0
    assert torch.equal(torch.round(q.float() * ratio).to(torch.int8), q)


def test_ragged_step_needs_touched_blocks_for_an_int8_pool(models):
    _, _, tmodel, tparams = models
    cache = tpm.init_paged_kv_cache(tmodel.cfg, 8, BS, torch.float32, "cpu",
                                    kv_quant=True)
    sm = DSStateManager(DSStateManagerConfig(**SM))
    rb = tbatch.pack([(1, np.arange(5))], sm)
    desc = (rb.ids, rb.row_ids, rb.positions, rb.lengths, rb.write_blocks,
            rb.write_offsets, rb.block_tables, rb.last_index)
    with pytest.raises(ValueError, match="touched_blocks"):
        tpm.paged_ragged_step(tmodel.cfg, tparams, *_t(*desc), cache, BS)
    # the batch carries the write-set's distinct blocks, null padded
    assert set(rb.touched_blocks) == {0} | set(rb.write_blocks)
    assert len(rb.touched_blocks) & (len(rb.touched_blocks) - 1) == 0


# ---------------------------------------------------------------------------
# int8 attention: plain versions against the JAX quant kernels
# ---------------------------------------------------------------------------
def _quant_pool(rng, nb=12, bs=16, kvh=2, hd=16):
    q8 = rng.integers(-127, 128, size=(nb, bs, kvh, hd)).astype(np.int8)
    s = rng.uniform(0.01, 0.2, size=(nb, kvh)).astype(np.float32)
    return q8, s


def _mixed_ragged(rng, nh=4, hd=16, T=32):
    tables = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 7]], np.int32)
    row_ids, lengths = [], []
    for r, positions in enumerate([range(10), range(20, 25), [40]]):
        for p in positions:
            row_ids.append(r)
            lengths.append(p + 1)
    n = len(row_ids)
    row_ids = np.array(row_ids + [0] * (T - n), np.int32)
    lengths = np.array(lengths + [0] * (T - n), np.int32)
    q = rng.normal(size=(T, nh, hd)).astype(np.float32)
    return q, row_ids, lengths, tables, n


@pytest.mark.parametrize("nh", [2, 4])
def test_q8_paged_plain_matches_jax_kernel(nh):
    rng = np.random.default_rng(10)
    kq, ks = _quant_pool(rng)
    vq, vs = _quant_pool(rng)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [7, 8, 9],
                       [0, 0, 0]], np.int32)
    lengths = np.array([40, 17, 1, 48, 0], np.int32)
    q = rng.normal(size=(5, nh, 16)).astype(np.float32)
    ref = np.asarray(jax_paged_attention(
        *map(jnp.asarray, (q, kq, vq, tables, lengths)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    out = paged_attention_plain(*_t(q, kq, vq, tables, lengths, ks, vs))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert (out[-1] == 0).all()


def test_q8_ragged_plain_matches_jax_kernel_mixed_rows():
    rng = np.random.default_rng(11)
    kq, ks = _quant_pool(rng)
    vq, vs = _quant_pool(rng)
    q, row_ids, lengths, tables, n = _mixed_ragged(rng)
    ref = np.asarray(jax_ragged_attention(
        *map(jnp.asarray, (q, kq, vq, row_ids, lengths, tables)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    out = ragged_attention_plain(
        *_t(q, kq, vq, row_ids, lengths, tables, ks, vs)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert (out[n:] == 0).all()


def test_q8_bf16_io_dequantizes_through_bf16_as_jax():
    """bf16 io: the page is f32(q8) * scale rounded to bf16, as
    _dequant_tile does, then read in f32 (one bf16 rounding of the
    outputs apart)."""
    rng = np.random.default_rng(12)
    kq, ks = _quant_pool(rng)
    vq, vs = _quant_pool(rng)
    q, row_ids, lengths, tables, n = _mixed_ragged(rng)
    qb = jnp.asarray(q, jnp.bfloat16)
    ref = np.asarray(jax_ragged_attention(
        qb, *map(jnp.asarray, (kq, vq, row_ids, lengths, tables)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)), np.float32)
    qt, *rest = _t(q, kq, vq, row_ids, lengths, tables, ks, vs)
    out = ragged_attention_plain(qt.to(torch.bfloat16), *rest)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_q8_ragged_pure_decode_equals_q8_paged():
    rng = np.random.default_rng(13)
    kq, ks = _quant_pool(rng)
    vq, vs = _quant_pool(rng)
    tables = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0], [7, 8, 9]],
                      np.int32)
    lengths = np.array([17, 33, 5, 48], np.int32)
    q = rng.normal(size=(4, 4, 16)).astype(np.float32)
    qt, kt, vt, tt, lt, kst, vst = _t(q, kq, vq, tables, lengths, ks, vs)
    ragged = ragged_attention_plain(qt, kt, vt,
                                    torch.arange(4, dtype=torch.int32), lt,
                                    tt, kst, vst)
    assert torch.equal(ragged, paged_attention_plain(qt, kt, vt, tt, lt,
                                                     kst, vst))
    # the wrappers take the plain version on CPU tensors, uncounted
    before = (paged_attention.q8_launches, ragged_attention.q8_launches)
    assert torch.equal(paged_attention(qt, kt, vt, tt, lt, kst, vst),
                       ragged)
    assert (paged_attention.q8_launches,
            ragged_attention.q8_launches) == before


@pytest.mark.parametrize("case", ["accepted", "one_scale", "pool_bf16",
                                  "scale_f16", "scale_shape",
                                  "scale_strided", "row_bytes"])
def test_q8_kernel_argument_checks(case):
    """An int8 pool takes f32 [nb, kvh] scales for K and V, contiguous;
    its rows must be 16-byte multiples (head_dim % 16)."""
    q = torch.zeros((3, 4, 32), dtype=torch.bfloat16)
    k = torch.zeros((5, 16, 2, 32), dtype=torch.int8)
    s = torch.ones((5, 2), dtype=torch.float32)
    tables = torch.zeros((3, 2), dtype=torch.int32)
    lens = torch.ones(3, dtype=torch.int32)
    args = dict(k_scale=s, v_scale=s.clone())
    pool = (k, k.clone())
    exc = ValueError
    if case == "one_scale":
        args["v_scale"] = None
    elif case == "pool_bf16":
        pool, exc = (k.bfloat16(), k.bfloat16()), TypeError
    elif case == "scale_f16":
        args["k_scale"], exc = s.half(), TypeError
    elif case == "scale_shape":
        args["k_scale"] = torch.ones((5, 4))
    elif case == "scale_strided":
        args["k_scale"] = torch.ones((2, 5)).t()
    elif case == "row_bytes":       # 8 int8 values: an 8-byte row
        q, pool = q[..., :8].contiguous(), (k[..., :8].contiguous(),) * 2
        args = dict(k_scale=s, v_scale=s)
    if case == "accepted":
        check_kernel_args("t", q, *pool, [lens], tables, **args)
        return
    with pytest.raises(exc):
        check_kernel_args("t", q, *pool, [lens], tables, **args)


# ---------------------------------------------------------------------------
# the kv_quant engine against the JAX kv_quant engine
# ---------------------------------------------------------------------------
def test_q8_pool_leaves_and_bytes_match_jax(models, jax_engines):
    je, te = jax_engines[8], _torch_engine(models, 8)
    assert set(te.kv_cache) == set(je.kv_cache) == {"k", "v", "ks", "vs"}
    for key, jv in je.kv_cache.items():
        tv = te.kv_cache[key]
        assert tuple(tv.shape) == jv.shape, key
        assert str(tv.dtype).replace("torch.", "") == str(jv.dtype), key
        assert tv.numel() * tv.element_size() == jv.nbytes, key
    # int8 plus one f32 scale per (block, head): about half of an fp16 pool
    bf = tpm.init_paged_kv_cache(te.model.cfg, SM["num_blocks"], BS,
                                 torch.bfloat16, "cpu")
    ratio = (sum(v.nbytes for v in te.kv_cache.values())
             / sum(v.nbytes for v in bf.values()))
    assert ratio == pytest.approx(0.5 * (1 + 4 / (BS * te.model.cfg.head_dim)))


def test_q8_put_logits_match_jax(models, jax_engines):
    je, te = jax_engines[8], _torch_engine(models, 8)
    p = _prompts(2, (14, 3, 22, 11))
    uids = [101, 102, 103]
    try:
        for batch_uids, toks in (
                (uids, p[:3]),                                 # prefills
                (uids, [[40], [41], [42]]),                   # decodes
                ([101, 104, 102], [[50], p[3], [51, 52, 53]])):  # mixed
            a = je.put(batch_uids, toks)
            b = te.put(batch_uids, toks)
            np.testing.assert_allclose(b, a, **LOGIT_TOL)
            np.testing.assert_array_equal(b.argmax(-1), a.argmax(-1))
    finally:
        for u in uids + [104]:
            je.flush(u)
    for key in ("ks", "vs"):          # the scales of the live blocks
        np.testing.assert_allclose(te.kv_cache[key][:, 1:].numpy(),
                                   np.asarray(je.kv_cache[key])[:, 1:],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("window", [8, 1])
def test_q8_generate_greedy_streams_match_jax(models, jax_engines, window):
    prompts = _prompts(3, (14, 3, 1, 30))
    a = jax_engines[window].generate(prompts, max_new_tokens=20)
    te = _torch_engine(models, window)
    b = te.generate(prompts, max_new_tokens=20)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert te.host_syncs == (te.decode_windows if window > 1
                             else te.decode_steps)
    assert te.state_manager.tracked_sequences() == 0


def test_q8_generate_kernel_route_equals_plain_route(models):
    """use_paged_kernel=False (the plain versions everywhere) gives the
    same streams on the CPU, where both routes run the plain versions."""
    prompts = _prompts(6, (9, 17))
    a = _torch_engine(models, 8).generate(prompts, max_new_tokens=12)
    b = _torch_engine(models, 8, use_paged_kernel=False).generate(
        prompts, max_new_tokens=12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _mixed_traffic(sched, prompts, new_tokens=10):
    for i, p in enumerate(prompts[:2]):
        sched.submit(100 + i, p, new_tokens,
                     temperature=0.7 if i == 1 else 0.0, top_p=0.9, seed=5)
    for _ in range(3):
        sched.step()
    for i, p in enumerate(prompts[2:]):
        sched.submit(200 + i, p, new_tokens,
                     temperature=0.9 if i % 2 else 0.0, top_k=30, seed=9)
    sched.run()
    return {uid: list(map(int, t)) for uid, t in sched.results().items()}


def test_q8_scheduler_streams_match_jax(models):
    """Fresh engines on both sides: a freed block keeps its grow-only scale
    for its next tenant (in both packages), so sampled streams depend on
    the pool's history."""
    prompts = _prompts(5, (40, 7, 22, 3, 30, 11), vocab=127)
    a = _mixed_traffic(JSched(_jax_engine(models, 8), token_budget=24,
                              chunk=16), prompts)
    b = _mixed_traffic(DynamicSplitFuseScheduler(
        _torch_engine(models, 8), token_budget=24, chunk=16), prompts)
    assert a == b


def test_q8_init_inference_routes_kv_quant(models):
    _, _, tmodel, tparams = models
    eng = deepspeed_tpu_torch.init_inference(
        tmodel, params=tparams, device="cpu",
        config={"dtype": "fp32", "use_ragged": True,
                "ragged": {"kv_quant": True, "state_manager": SM}})
    assert isinstance(eng, InferenceEngineV2) and eng.config.kv_quant
    assert eng.kv_cache["k"].dtype == torch.int8
    assert eng.kv_cache["ks"].shape == (tmodel.cfg.num_layers,
                                        SM["num_blocks"], tmodel.cfg.kv_heads)
    out = eng.generate([[3, 4, 5]], max_new_tokens=3)
    assert len(out[0]) == 6

"""PyTorch port: the serving slice against the JAX package.

The same weights (initialized by the JAX package, moved by name through
``checkpoint.interop.params_from_numpy``) and the same numpy inputs go
through ``deepspeed_tpu`` and ``deepspeed_tpu_torch`` on the CPU in fp32.
The JAX side runs as its own tests run it: engines with
``dtype="float32"``, Pallas kernels in interpret mode. Held equal:

* RaggedBatch descriptors for one allocation sequence (exactly);
* paged_ragged_step / paged_decode / paged_decode_window logits (2e-4,
  the JAX tests' ragged-vs-stitched tolerance), argmax tokens and the KV
  pool;
* put() logits, greedy generate() streams (fused window and per-token),
  pipeline() streams and seeded scheduler streams (host_sample with a
  per-request numpy Generator): token-identical.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.v2 import DynamicSplitFuseScheduler as JSched
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2 import paged_model as jpm
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.ragged import batch as jbatch
from deepspeed_tpu.inference.v2.ragged.ragged_manager import \
    DSStateManager as JStateManager
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models.transformer import tiny_test as jax_tiny_test

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2 import paged_model as tpm
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
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


@pytest.fixture(scope="module")
def models():
    """JAX model + numpy weights, and the port's model + the same weights
    (tiny_test widths, 4 q heads over 2 kv heads, 2 layers)."""
    jcfg = dataclasses.replace(jax_tiny_test(), num_kv_heads=2)
    jmodel = JModel(jcfg)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    return jmodel, np_params, tmodel, params_from_numpy(np_params)


def _jax_engine(models, window):
    jmodel, np_params, _, _ = models
    return JEngine(jmodel, JConfig(state_manager=JSM(**SM), dtype="float32",
                                   prefill_bucket=16, decode_window=window),
                   params=np_params)


def _torch_engine(models, window):
    _, _, tmodel, tparams = models
    return InferenceEngineV2(
        tmodel, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(**SM), dtype="float32",
            prefill_bucket=16, decode_window=window),
        params=tparams, device="cpu")


@pytest.fixture(scope="module")
def jax_engines(models):
    # module-scoped: each JAX engine compiles its programs once
    return {w: _jax_engine(models, w) for w in (1, 8)}


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lengths]


# ---------------------------------------------------------------------------
# (b) RaggedBatch descriptors
# ---------------------------------------------------------------------------
def test_ragged_batch_descriptors_identical_to_jax():
    jsm = JStateManager(JSM(**SM))
    tsm = DSStateManager(DSStateManagerConfig(**SM))
    steps = [
        [(1, np.arange(10)), (2, np.arange(40))],                # prefills
        [(1, np.array([7])), (2, np.array([9])),
         (3, np.arange(3, 20))],                                 # mixed
        [(2, np.arange(30)), (1, np.array([5]))],               # chunk
        [(3, np.array([4])), (1, np.array([6])), (2, np.array([1]))],
    ]
    for entries in steps:
        jb = jbatch.pack(entries, jsm)
        tb = tbatch.pack(entries, tsm)
        for f in dataclasses.fields(jb):
            a, b = getattr(jb, f.name), getattr(tb, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        assert jb.pad_fraction == tb.pad_fraction
        for sm in (jsm, tsm):           # commit, as the engines do
            for uid, toks in entries:
                sm.seqs[uid].seen_tokens += len(toks)
    jsm.flush_sequence(2)
    tsm.flush_sequence(2)
    assert jsm.free_blocks() == tsm.free_blocks()
    assert jsm.allocator._free == tsm.allocator._free


# ---------------------------------------------------------------------------
# (c) paged_model entry points
# ---------------------------------------------------------------------------
def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_paged_model_steps_match_jax(models):
    jmodel, np_params, tmodel, tparams = models
    cfg_j, cfg_t = jmodel.cfg, tmodel.cfg
    jparams = jax.tree.map(jnp.asarray, np_params)
    jcache = jpm.init_paged_kv_cache(cfg_j, SM["num_blocks"], BS,
                                     jnp.float32)
    tcache = tpm.init_paged_kv_cache(cfg_t, SM["num_blocks"], BS,
                                     torch.float32, "cpu")
    sm = DSStateManager(DSStateManagerConfig(**SM))

    def check_pool():
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=2e-4,
                                       atol=2e-5)

    # -- one mixed ragged step: two prefills + a later chunk row ---------
    p = _prompts(0, (21, 9, 14))
    ragged = jax.jit(functools.partial(jpm.paged_ragged_step, cfg_j,
                                       block_size=BS, use_kernel=True))
    for entries in ([(1, np.array(p[0])), (2, np.array(p[1]))],
                    [(1, np.array([p[2][0]])), (2, np.array(p[2][1:6])),
                     (3, np.array(p[2]))]):
        rb = tbatch.pack(entries, sm)
        desc = (rb.ids, rb.row_ids, rb.positions, rb.lengths,
                rb.write_blocks, rb.write_offsets, rb.block_tables,
                rb.last_index)
        jl, jcache = ragged(jparams, *map(_j, desc), cache=jcache)
        tl = tpm.paged_ragged_step(cfg_t, tparams, *map(_t, desc), tcache,
                                   BS)
        n = len(entries)
        np.testing.assert_allclose(tl.numpy()[:n], np.asarray(jl)[:n],
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(tl.numpy()[:n].argmax(-1),
                                      np.asarray(jl)[:n].argmax(-1))
        for uid, toks in entries:
            sm.seqs[uid].seen_tokens += len(toks)
    check_pool()

    # -- one decode step over the three rows -----------------------------
    N, MB = 4, 4
    uids = [1, 2, 3]
    tables = np.zeros((N, MB), np.int32)
    pos = np.zeros(N, np.int32)
    for i, u in enumerate(uids):
        seq = sm.ensure_blocks(u, 8)          # room for the window below
        tables[i, :len(seq.blocks)] = seq.blocks
        pos[i] = seq.seen_tokens
    toks = np.array([5, 6, 7, 0], np.int32)
    active = np.array([1, 1, 1, 0], bool)
    decode = jax.jit(functools.partial(jpm.paged_decode, cfg_j,
                                       block_size=BS, use_kernel=True))
    jl, jcache = decode(jparams, _j(toks), _j(pos), _j(tables),
                        cache=jcache, active=_j(active))
    tl = tpm.paged_decode(cfg_t, tparams, _t(toks), _t(pos), _t(tables),
                          tcache, _t(active), BS)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3],
                               **LOGIT_TOL)
    np.testing.assert_array_equal(tl.numpy()[:3].argmax(-1),
                                  np.asarray(jl)[:3].argmax(-1))
    check_pool()

    # -- a fused window with per-row budgets -----------------------------
    pos = pos + active
    steps_left = np.array([6, 2, 6, 0], np.int32)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    eos = np.full(N, -1, np.int32)
    window = jax.jit(functools.partial(jpm.paged_decode_window, cfg_j,
                                       block_size=BS, window=6,
                                       use_kernel=True))
    jout, jcache = window(jparams, _j(first), _j(pos), _j(tables),
                          cache=jcache, steps_left=_j(steps_left),
                          eos_ids=_j(eos))
    tout = tpm.paged_decode_window(cfg_t, tparams, _t(first), _t(pos),
                                   _t(tables), tcache, _t(steps_left),
                                   _t(eos), BS, 6)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert (tout.numpy()[1, 2:] == -1).all() and (tout.numpy()[3] == -1).all()
    check_pool()


def test_decode_window_eos_cut_matches_jax(models, jax_engines):
    """A row that emits its EOS stops: the EOS is emitted, later steps emit
    -1 and write only to the null block."""
    prompts = _prompts(1, (12, 7))
    ref = jax_engines[8].generate(prompts, max_new_tokens=10)
    eos = int(ref[0][len(prompts[0]) + 2])   # row 0's third token
    a = jax_engines[8].generate(prompts, max_new_tokens=10,
                                eos_token_id=eos)
    b = _torch_engine(models, 8).generate(prompts, max_new_tokens=10,
                                          eos_token_id=eos)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(b[0]) <= len(prompts[0]) + 3


# ---------------------------------------------------------------------------
# (d) engine, pipeline and scheduler streams
# ---------------------------------------------------------------------------
def test_put_logits_match_jax(models, jax_engines):
    je = jax_engines[8]
    te = _torch_engine(models, 8)
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


@pytest.mark.parametrize("window", [8, 1])
def test_generate_greedy_streams_match_jax(models, jax_engines, window):
    prompts = _prompts(3, (14, 3, 1, 30))
    a = jax_engines[window].generate(prompts, max_new_tokens=20)
    te = _torch_engine(models, window)
    b = te.generate(prompts, max_new_tokens=20)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # one host read per window (or per token at window 1); every row's
    # blocks came back
    assert te.host_syncs == (te.decode_windows if window > 1
                             else te.decode_steps)
    assert te.state_manager.tracked_sequences() == 0


def test_pipeline_streams_match_jax(models, jax_engines):
    _, _, tmodel, tparams = models
    prompts = _prompts(4, (9, 25, 4))
    jpipe = deepspeed_tpu.ServePipeline(jax_engines[8])
    tpipe = deepspeed_tpu_torch.pipeline(
        tmodel.cfg, params=tparams, device="cpu",
        config={"dtype": "float32",
                "ragged": {"prefill_bucket": 16, "state_manager": SM}})
    a = jpipe(prompts, max_new_tokens=12)
    b = tpipe(prompts, max_new_tokens=12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    full = tpipe(prompts, max_new_tokens=12, return_full_text=True)
    for f, p, y in zip(full, prompts, b):
        np.testing.assert_array_equal(f, list(p) + list(y))
    assert tpipe.engine.state_manager.tracked_sequences() == 0


def _mixed_traffic(sched, prompts, new_tokens=10):
    """Staggered submissions so steps interleave prompt chunks with running
    decodes; greedy and seeded sampled requests mixed."""
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


@pytest.mark.parametrize("window", [8, 1])
def test_scheduler_streams_match_jax(models, jax_engines, window):
    prompts = _prompts(5, (40, 7, 22, 3, 30, 11), vocab=127)
    a = _mixed_traffic(JSched(jax_engines[window], token_budget=24,
                              chunk=16), prompts)
    b = _mixed_traffic(DynamicSplitFuseScheduler(
        _torch_engine(models, window), token_budget=24, chunk=16), prompts)
    assert a == b


# ---------------------------------------------------------------------------
# (e) device resolution, unported features, parameters
# ---------------------------------------------------------------------------
def test_entry_points_raise_without_cuda(models, monkeypatch):
    _, _, tmodel, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngineV2(tmodel, RaggedInferenceEngineConfig(),
                          params=tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.pipeline(tmodel.cfg, params=tparams)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngineV2(tmodel, params=tparams, device="cuda")


@pytest.mark.parametrize("field,value", [
    ("ragged_attention", "off"),
    ("max_lora_adapters", 2), ("tensor_parallel_size", 2),
    ("expert_parallel_size", 2)])
def test_unported_config_features_raise(field, value):
    if field == "ragged_attention":
        # the stitched dispatch is served now (tests/test_torch_stitched.py)
        assert RaggedInferenceEngineConfig(
            ragged_attention=value).ragged_attention == "off"
        return
    if field in ("tensor_parallel_size", "expert_parallel_size"):
        # and so are tensor parallelism (tests/test_torch_tensor_parallel.
        # py) and expert parallelism (tests/test_torch_parallel_serving.py)
        assert getattr(RaggedInferenceEngineConfig(**{field: value}),
                       field) == 2
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        RaggedInferenceEngineConfig(**{field: value})


def test_config_validation_matches_jax():
    # the spill tier keys on prefix digests: both packages refuse it
    # without prefix caching, with the same message
    msgs = []
    for cls in (JSM, DSStateManagerConfig):
        with pytest.raises(ValueError, match="enable_prefix_caching") as e:
            cls(enable_kv_spill=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for kw in ({"decode_window": 0}, {"decode_window": 65},
               {"prefill_bucket": 0}, {"spec_mode": "x"}):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            RaggedInferenceEngineConfig(**kw)
    # the JAX engine rejects an unknown ragged mode at construction; the
    # port's config rejects it one step earlier
    with pytest.raises(ValueError, match="ragged_attention"):
        RaggedInferenceEngineConfig(ragged_attention="maybe")


def test_generate_options_not_ported_raise(models):
    te = _torch_engine(models, 8)
    with pytest.raises(NotImplementedError, match="A11"):
        te.generate([[1, 2, 3]], max_new_tokens=4, speculative=True)
    with pytest.raises(NotImplementedError, match="A11"):
        te.generate([[1, 2, 3]], max_new_tokens=4, adapter="a")
    with pytest.raises(NotImplementedError):
        deepspeed_tpu_torch.pipeline("mistralai/Mistral-7B-v0.1")
    # the v1 engine serves at tp 2 over two ranks now (tests/test_torch_
    # tensor_parallel.py); one rank cannot hold a model axis of 2
    with pytest.raises(ValueError, match="does not divide"):
        deepspeed_tpu_torch.init_inference(
            te.model, config={"dtype": "fp32", "tensor_parallel": 2},
            device="cpu")


def test_v1_only_inference_keys_are_reported_not_accepted(caplog):
    """The v1 engine's knobs are config fields; keys nothing reads yet are
    named as ignored instead of taken silently."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    with caplog.at_level("WARNING"):
        cfg = DeepSpeedInferenceConfig.from_dict_or_kwargs(
            {"use_ragged": True, "enable_cuda_graph": True},
            {"max_out_tokens": 64, "dtype": "bf16"})
    assert "unknown config keys ['enable_cuda_graph']" in caplog.text
    assert cfg.max_out_tokens == 64
    assert not hasattr(cfg, "enable_cuda_graph")
    assert (cfg.use_ragged, cfg.dtype) == (True, "bfloat16")


def test_init_params_layout_and_distribution(models):
    """Seeded init keeps the JAX tree's names, shapes and scales (the bits
    differ: torch's generator is not threefry)."""
    _, np_params, tmodel, _ = models
    gen = torch.Generator().manual_seed(0)
    p = tmodel.init_params(gen, dtype=torch.float32)
    assert _flatten(np_params) == _flatten(p)
    L = tmodel.cfg.num_layers
    assert abs(float(p["layers"]["wq"].std()) - 0.02) < 2e-3
    assert abs(float(p["layers"]["wo"].std()) - 0.02 / np.sqrt(2 * L)) < 1e-3
    assert torch.equal(p["final_norm"], torch.ones_like(p["final_norm"]))
    again = tmodel.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], p["embed"])       # seeded


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_scheduler_cancel_release_and_admission(models):
    """The copied scheduler's lifecycle: streaming hook, cancel frees the
    KV blocks, release lets a uid be resubmitted, over-long requests are
    refused at submit."""
    te = _torch_engine(models, 8)
    sched = DynamicSplitFuseScheduler(te, token_budget=24, chunk=16)
    seen = []
    sched.submit(1, list(range(1, 30)), 6,
                 on_token=lambda u, t, done: seen.append((u, done)))
    sched.submit(2, list(range(1, 40)), 6)
    sched.step()
    free_mid = te.state_manager.free_blocks()
    assert sched.cancel(2) and not sched.cancel(2)
    assert te.state_manager.free_blocks() > free_mid
    sched.run()
    assert sched.results().keys() == {1}
    assert len(seen) == 6 and seen[-1] == (1, True)
    assert sched.metrics()[1]["new_tokens"] == 6
    with pytest.raises(ValueError, match="already submitted"):
        sched.submit(1, [1, 2], 2)
    sched.release(1)
    sched.submit(1, [1, 2], 2)
    sched.run()
    assert te.state_manager.tracked_sequences() == 0
    with pytest.raises(RuntimeError, match="max_seq_len"):
        sched.submit(3, list(range(120)), 20)

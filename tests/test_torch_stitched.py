"""PyTorch port: the stitched dispatch of ``ragged_attention="off"``
against the JAX package.

The same weights (initialized by the JAX package, moved by name through
``params_from_numpy``) and the same numpy inputs go through
``deepspeed_tpu`` and ``deepspeed_tpu_torch`` on the CPU in fp32; the JAX
functions are jitted (XLA's rewrites, e.g. a division by a constant into
a reciprocal multiply, make eager JAX the wrong oracle) and its Pallas
flash kernel runs in interpret mode, as the JAX tests run it; the port's
flash wrapper runs its plain version on CPU tensors. Held:

* ``_kv_read`` bit-identical to JAX's on a bf16 pool and an int8 pool;
* ``paged_prefill`` at a bucket of 128 (the flash route) and of 48 (plain
  attention), ``paged_continue`` over a prefilled sequence, on the fp32
  pool and on the int8 pool: last-token logits and the pool outside the
  null block within 2e-5;
* the ``ragged_attention="off"`` engine against the JAX engine in "off":
  put() logits within 2e-4, greedy ``generate()`` streams and SplitFuse
  scheduler streams token-identical; "off" against "on" (the ragged step)
  within 2e-4, as JAX's ``test_ragged_attention.py:176-200,319-344``
  holds its two paths.
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
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.models.transformer import tiny_test as jax_tiny_test

from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2 import paged_model as tpm
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.ops import flash_attention as tfa

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

BS = 16
NB = 40
SM = dict(max_tracked_sequences=8, max_seq_len=256, num_blocks=NB,
          block_size=BS)
TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models():
    """tiny_test widths (hidden 128, 2 layers, head_dim 32), 4 q heads
    over 2 kv heads, 256 positions."""
    jcfg = dataclasses.replace(jax_tiny_test(seq=256), num_kv_heads=2)
    jmodel = JModel(jcfg)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                             jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = TransformerLM(TransformerConfig(**dataclasses.asdict(jcfg)))
    return jcfg, np_params, tmodel, params_from_numpy(np_params)


def _pools(models, kv_quant):
    jcfg, _, tmodel, _ = models
    j = jpm.init_paged_kv_cache(jcfg, NB, BS, jnp.float32,
                                kv_quant=kv_quant)
    t = tpm.init_paged_kv_cache(tmodel.cfg, NB, BS, torch.float32, "cpu",
                                kv_quant=kv_quant)
    return j, t


def _write_set(blocks, start, n, C):
    """(block ids, offsets, distinct blocks) of ``n`` tokens at position
    ``start`` padded to ``C`` (padding to the null block)."""
    pos = start + np.arange(C)
    valid = np.arange(C) < n
    table = np.zeros(C, np.int32)
    table[valid] = np.asarray(blocks, np.int32)[pos[valid] // BS]
    return table, (pos % BS).astype(np.int32), np.unique(table)


def _same_pool(jc, tc):
    for key in jc:
        a = np.asarray(jc[key])[:, 1:]     # the null block takes padding
        b = tc[key].numpy()[:, 1:]
        if a.dtype == np.int8:
            # one rounding step of an int8 code at most, where a scale
            # or a value sits within f32 rounding of a .5 boundary
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, key
            assert (a != b).mean() < 1e-3, key
        else:
            np.testing.assert_allclose(b, a, **TOL)


def _prefill_both(models, kv_quant, n, C, blocks, ids):
    jcfg, np_params, tmodel, tparams = models
    jc, tc = _pools(models, kv_quant)
    table, offs, touched = _write_set(blocks, 0, n, C)
    jfn = jax.jit(functools.partial(jpm.paged_prefill, jcfg))
    jl, jc = jfn(np_params, jnp.asarray(ids), jnp.asarray(n), jc,
                 jnp.asarray(table), jnp.asarray(offs))
    tl = tpm.paged_prefill(tmodel.cfg, tparams, torch.from_numpy(ids), n,
                           tc, torch.from_numpy(table),
                           torch.from_numpy(offs),
                           touched_blocks=torch.from_numpy(touched))
    return jl, jc, tl, tc


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n,C", [(100, 128), (40, 48)],
                         ids=["flash", "plain"])
def test_paged_prefill_matches_jax(models, kv_quant, n, C, monkeypatch):
    """The prompt's K/V land in the pool and the last-token logits agree;
    the 128 bucket runs the flash wrapper, the 48 bucket plain
    attention."""
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    rng = np.random.default_rng(n)
    ids = np.zeros((1, C), np.int32)
    ids[0, :n] = rng.integers(1, 256, n)
    blocks = [5, 9, 2, 30, 17, 11, 3, 22][:-(-C // BS)]
    jl, jc, tl, tc = _prefill_both(models, kv_quant, n, C, blocks, ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_pool(jc, tc)
    assert len(calls) == (models[0].num_layers if C % 128 == 0 else 0)


def test_prefill_needs_touched_blocks_on_int8(models):
    _, _, tmodel, tparams = models
    _, tc = _pools(models, True)
    z = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="touched_blocks"):
        tpm.paged_prefill(tmodel.cfg, tparams, z[None], 4, tc, z, z)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_paged_continue_matches_jax(models, kv_quant):
    """A 37-token prompt, then a 21-token continuation over the whole
    block table (bucket 32)."""
    jcfg, np_params, tmodel, tparams = models
    rng = np.random.default_rng(7)
    blocks = [4, 12, 7, 25]
    n0, C0 = 37, 48
    ids = np.zeros((1, C0), np.int32)
    ids[0, :n0] = rng.integers(1, 256, n0)
    _, jc, _, tc = _prefill_both(models, kv_quant, n0, C0, blocks[:3], ids)
    n, C = 21, 32
    cont = np.zeros((1, C), np.int32)
    cont[0, :n] = rng.integers(1, 256, n)
    table, offs, touched = _write_set(blocks, n0, n, C)
    full = np.asarray(blocks, np.int32)
    jfn = jax.jit(functools.partial(jpm.paged_continue, jcfg),
                  static_argnames=("block_size",))
    jl, jc = jfn(np_params, jnp.asarray(cont), jnp.asarray(n0),
                 jnp.asarray(n), jc, jnp.asarray(table), jnp.asarray(offs),
                 jnp.asarray(full), block_size=BS)
    tl = tpm.paged_continue(tmodel.cfg, tparams, torch.from_numpy(cont), n0,
                            n, tc, torch.from_numpy(table),
                            torch.from_numpy(offs), torch.from_numpy(full),
                            BS, touched_blocks=torch.from_numpy(touched))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_pool(jc, tc)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_kv_read_matches_jax(pool):
    rng = np.random.default_rng(3)
    shape = (2, 9, BS, 2, 32)
    table = np.array([[3, 1, 8], [0, 5, 5]], np.int32)
    jread = jax.jit(jpm._kv_read, static_argnums=(2, 4))
    if pool == "bf16":
        x = rng.standard_normal(shape).astype(np.float32)
        jk = jnp.asarray(x, jnp.bfloat16)
        want = np.asarray(jread(jk, None, 1, jnp.asarray(table),
                                jnp.bfloat16).astype(jnp.float32))
        got = tpm._kv_read(torch.from_numpy(x).to(torch.bfloat16), None, 1,
                           torch.from_numpy(table).long(),
                           torch.bfloat16).float().numpy()
    else:
        q = rng.integers(-127, 128, shape).astype(np.int8)
        sc = rng.uniform(0.01, 0.1, (2, 9, 2)).astype(np.float32)
        want = np.asarray(jread(jnp.asarray(q), jnp.asarray(sc), 1,
                                jnp.asarray(table), jnp.float32))
        got = tpm._kv_read(torch.from_numpy(q), torch.from_numpy(sc), 1,
                           torch.from_numpy(table).long(),
                           torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
def _jax_engine(models, mode, window=8):
    _, np_params, _, _ = models
    return JEngine(JModel(models[0]), JConfig(
        state_manager=JSM(**SM), dtype="float32", prefill_bucket=16,
        decode_window=window, ragged_attention=mode), params=np_params)


def _torch_engine(models, mode, window=8):
    _, _, tmodel, tparams = models
    return InferenceEngineV2(tmodel, RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(**SM), dtype="float32",
        prefill_bucket=16, decode_window=window, ragged_attention=mode),
        params=tparams, device="cpu")


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 256, n))) for n in lengths]


@pytest.fixture(scope="module")
def engines(models):
    return {"jax": _jax_engine(models, "off"),
            "off": _torch_engine(models, "off"),
            "on": _torch_engine(models, "on")}


def test_off_put_matches_jax_and_the_ragged_step(engines):
    """A put() with two new prompts (one at a 128 bucket: flash), then one
    with a decode token, a 9-token continuation and a new prompt: each
    entry's logits against the JAX "off" engine and the port's ragged
    engine."""
    p = _prompts(11, (128, 30, 50))
    rng = np.random.default_rng(12)
    steps = [([1, 2], [p[0], p[1]]),
             ([1, 2, 3], [[int(rng.integers(1, 256))],
                          list(map(int, rng.integers(1, 256, 9))), p[2]])]
    for uids, toks in steps:
        j = np.asarray(engines["jax"].put(uids, toks))
        off = engines["off"].put(uids, toks)
        on = engines["on"].put(uids, toks)
        np.testing.assert_allclose(off, j, **LOGIT_TOL)
        np.testing.assert_allclose(off, on, **LOGIT_TOL)
    assert engines["off"].ragged_steps == 0
    assert engines["on"].ragged_steps == 2
    for eng in engines.values():
        for u in (1, 2, 3):
            eng.flush(u)


@pytest.mark.parametrize("window", [1, 8])
def test_off_generate_streams_match_jax(models, window):
    prompts = _prompts(21, (128, 7, 33))
    j = _jax_engine(models, "off", window).generate(prompts,
                                                    max_new_tokens=12)
    t = _torch_engine(models, "off", window).generate(prompts,
                                                      max_new_tokens=12)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_off_scheduler_streams_match_jax(models):
    """Prompts longer than the scheduler's chunk: prefill, then
    continuations, then decode, all on the stitched dispatch."""
    prompts = _prompts(31, (70, 20))
    outs = {}
    for name, eng, sched in (
            ("jax", _jax_engine(models, "off"), JSched),
            ("torch", _torch_engine(models, "off"),
             DynamicSplitFuseScheduler)):
        s = sched(eng, token_budget=64, chunk=32)
        for uid, p in enumerate(prompts):
            s.submit(uid, p, 6)
        s.run()
        outs[name] = {u: list(map(int, t)) for u, t in s.results().items()}
    assert outs["torch"] == outs["jax"] and len(outs["torch"]) == 2


def test_set_ragged_mode_flips_the_dispatch(models):
    eng = _torch_engine(models, "auto")
    assert eng.ragged_enabled
    eng.set_ragged_mode("off")
    assert not eng.ragged_enabled and eng.config.ragged_attention == "off"
    eng.put([1], [_prompts(41, (20,))[0]])
    assert eng.ragged_steps == 0
    eng.set_ragged_mode("on")
    eng.put([1], [[5]])
    assert eng.ragged_steps == 1
    with pytest.raises(ValueError, match="ragged_attention"):
        eng.set_ragged_mode("sometimes")


def test_serving_runtime_routes_off(models):
    """ServingConfig(ragged_attention="off") puts the engine on the
    stitched dispatch; a request streams the tokens generate() gives."""
    import asyncio

    from deepspeed_tpu_torch.inference.v2 import serve

    prompt = _prompts(51, (40,))[0]
    want = _torch_engine(models, "off").generate([prompt], 6)[0][40:]
    eng = _torch_engine(models, "on")

    async def main():
        s = serve.ServingEngine(eng, serve.ServingConfig(
            ragged_attention="off"))
        try:
            assert not eng.ragged_enabled
            await s.start()
            stream = await s.submit(prompt, 6)
            return [t async for t in stream]
        finally:
            await s.stop()

    assert asyncio.run(main()) == list(map(int, want))
    assert eng.ragged_steps == 0

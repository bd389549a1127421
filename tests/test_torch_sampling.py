"""PyTorch port: device-side sampling (``inference/v2/sampling.py``).

JAX draws with threefry keys, whose bits the port cannot reproduce, so
the draws themselves are held to their distribution and to the port's
own invariants, and the deterministic parts to the JAX package:

* the top-p / top-k support set equals JAX ``_sorted_support``'s on the
  same logits (a token whose cumulative mass before it lies within f32
  rounding of top_p may fall on either side: the cumsums associate
  differently);
* row keys depend only on (base seed, row seed, generated-token index):
  the same bits whatever the batch around a row or its padding, and the
  hash's products never leave int64 (checked against Python integers);
* ``top_k=1`` is greedy;
* ``sample_tokens`` (one key for the batch) draws row r with the key
  folded with r, within JAX's support, and its draws and JAX's pass a
  two-sample chi-square test;
* 20,000 draws at vocabulary 16 pass a chi-square test against
  softmax(logits / T) under the top-p mask (fixed seed, threshold the
  0.999 quantile of chi-square);
* on a tiny f32 engine the sampled fused window equals the per-token
  sampled path bit for bit, with one host read per window.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats

from deepspeed_tpu.inference.v2 import sampling as jsampling
from deepspeed_tpu.models.transformer import tiny_test as jax_tiny_test

from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import sampling as S
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)


def _support_sets(order, masked):
    order, masked = np.asarray(order), np.asarray(masked)
    return [set(order[r][masked[r] > S.NEG_INF / 2].tolist())
            for r in range(order.shape[0])]


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (1.0, 1.0, 0), (0.8, 0.9, 0), (0.5, 0.5, 0), (1.3, 0.95, 40),
    (0.7, 1.0, 5), (1.0, 0.0, 0), (0.9, 0.3, 3), (2.0, 0.99, 1)])
def test_support_set_matches_jax(temperature, top_p, top_k):
    rng = np.random.default_rng(int(temperature * 100 + top_p * 10 + top_k))
    logits = (rng.standard_normal((6, 200)) * 3).astype(np.float32)
    n = logits.shape[0]
    args = (np.full(n, temperature, np.float32),
            np.full(n, top_p, np.float32), np.full(n, top_k, np.int32))
    jorder, jmasked = jsampling._sorted_support(
        jnp.asarray(logits), *map(jnp.asarray, args))
    torder, tmasked = S._sorted_support(torch.from_numpy(logits),
                                        *map(torch.from_numpy, args))
    tsets = _support_sets(torder, tmasked)
    jsets = _support_sets(jorder, jmasked)
    # the sets are equal except for a token whose cumulative mass before
    # it lies within f32 rounding of top_p: the two cumsums associate
    # differently (with top_p = 1.0 the tail's cumulative mass reaches
    # 1.0 in f32 in one order and not the other)
    scaled = logits.astype(np.float64) / max(temperature, 1e-6)
    for r, (ts, js) in enumerate(zip(tsets, jsets)):
        order = np.argsort(-scaled[r], kind="stable")
        p = np.exp(scaled[r][order] - scaled[r][order].max())
        p /= p.sum()
        before = dict(zip(order.tolist(), np.cumsum(p) - p))
        for tok in ts ^ js:
            assert abs(before[tok] - max(top_p, 1e-9)) < 1e-5, (r, tok)
    if top_p < 0.99:
        assert tsets == jsets
    # the support is a prefix of the descending order
    for row in tmasked.numpy():
        kept = row > S.NEG_INF / 2
        n = int(kept.sum())
        assert n >= 1 and kept[:n].all() and not kept[n:].any()


def test_mul32_and_mix32_exact():
    rng = np.random.default_rng(0)
    xs = [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF] + \
        [int(v) for v in rng.integers(0, 1 << 32, 200, dtype=np.int64)]
    x = torch.tensor(xs, dtype=torch.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 1, 0xFFFFFFFF):
        assert S._mul32(x, c).tolist() == [(v * c) % (1 << 32) for v in xs]

    def mix(v):
        v ^= v >> 16
        v = (v * 0x85EBCA6B) % (1 << 32)
        v ^= v >> 13
        v = (v * 0xC2B2AE35) % (1 << 32)
        return v ^ (v >> 16)
    assert S._mix32(x).tolist() == [mix(v) for v in xs]


def test_row_keys_ignore_batch_composition_and_padding():
    rng = S.prng_key(1234)
    seeds = torch.tensor([0, 1, 2, 3, 4, 5])
    gidx = torch.tensor([0, 3, 7, 7, 1, 0])
    keys = S.fold_in_rows(rng, seeds, gidx)
    assert keys.dtype == torch.int64
    assert int(keys.min()) >= 0 and int(keys.max()) < 1 << 32
    assert len(set(keys.tolist())) == 6
    # a sub-batch, a permutation, padding rows and int32 inputs: same keys
    sub = S.fold_in_rows(rng, torch.tensor([4, 2]), torch.tensor([1, 7]))
    assert sub.tolist() == [keys[4].item(), keys[2].item()]
    padded = S.fold_in_rows(rng, torch.tensor([2, 0, 0, 0], dtype=torch.int32),
                            torch.tensor([7, 0, 0, 0], dtype=torch.int32))
    assert padded[0].item() == keys[2].item()
    # the draw of a row depends on its own key and logits only
    gen = np.random.default_rng(1)
    logits = torch.from_numpy(gen.standard_normal((6, 50)).astype(np.float32))
    t = torch.full((6,), 0.9)
    p = torch.full((6,), 0.95)
    k = torch.zeros(6, dtype=torch.int32)
    full = S.sample_tokens_rowwise(logits, keys, t, p, k)
    part = S.sample_tokens_rowwise(logits[[4, 2]], sub, t[:2], p[:2], k[:2])
    assert part.tolist() == [full[4].item(), full[2].item()]
    # other seeds or another base key change the keys
    assert S.prng_key(1235).item() != rng.item()
    assert S.prng_key(-1).item() != S.prng_key(1 << 32).item()


def test_top_k_one_and_zero_temperature_are_greedy():
    gen = np.random.default_rng(2)
    logits = torch.from_numpy(gen.standard_normal((16, 300)).astype(
        np.float32))
    keys = S.fold_in_rows(S.prng_key(0), torch.arange(16),
                          torch.zeros(16, dtype=torch.int64))
    greedy = S.greedy_tokens(logits)
    for t, k in ((0.8, 1), (1.5, 1), (0.0, 0), (-1.0, 50)):
        out = S.sample_tokens_rowwise(
            logits, keys, torch.full((16,), t), torch.full((16,), 0.9),
            torch.full((16,), k, dtype=torch.int32))
        assert torch.equal(out, greedy)
    # top_p <= 0 keeps only the top token
    out = S.sample_tokens_rowwise(logits, keys, torch.full((16,), 1.0),
                                  torch.zeros(16),
                                  torch.zeros(16, dtype=torch.int32))
    assert torch.equal(out, greedy)


def test_sample_tokens_folds_the_row_index_into_one_batch_key():
    """``sample_tokens`` draws row r with the batch key folded with r (and
    generated-token index 0). Its draws lie in JAX's support set, and
    4,000 of them at V 16 pass a two-sample chi-square test (p > 0.001)
    against 4,000 draws of the JAX ``sample_tokens`` on the same logits."""
    gen = np.random.default_rng(4)
    V, N, T, P, K = 16, 4000, 1.2, 0.9, 12
    row = gen.standard_normal(V).astype(np.float32)
    logits = np.broadcast_to(row, (N, V)).copy()
    args = (np.full(N, T, np.float32), np.full(N, P, np.float32),
            np.full(N, K, np.int32))
    targs = [torch.from_numpy(a) for a in args]
    rng = S.prng_key(21)
    out = S.sample_tokens(torch.from_numpy(logits), rng, *targs)
    keys = S.fold_in_rows(rng, torch.arange(N), torch.zeros(N,
                                                            dtype=torch.int64))
    assert torch.equal(out, S.sample_tokens_rowwise(
        torch.from_numpy(logits), keys, *targs))
    # a shorter batch draws its rows as the first rows of the longer one
    assert torch.equal(S.sample_tokens(torch.from_numpy(logits[:7]), rng,
                                       *(a[:7] for a in targs)), out[:7])
    jorder, jmasked = jsampling._sorted_support(
        jnp.asarray(logits[:1]), *(jnp.asarray(a[:1]) for a in args))
    support = _support_sets(jorder, jmasked)[0]
    assert set(out.tolist()) <= support
    jout = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(21),
        *map(jnp.asarray, args)))
    assert set(jout.tolist()) <= support
    idx = sorted(support)
    table = np.stack([np.bincount(out.numpy(), minlength=V)[idx],
                      np.bincount(jout, minlength=V)[idx]])
    assert stats.chi2_contingency(table).pvalue > 1e-3, table
    # temperature 0 and top_k 1 rows are greedy
    greedy = S.greedy_tokens(torch.from_numpy(logits[:8]))
    for t, k in ((0.0, 0), (0.8, 1)):
        assert torch.equal(S.sample_tokens(
            torch.from_numpy(logits[:8]), rng, torch.full((8,), t),
            torch.full((8,), P), torch.full((8,), k, dtype=torch.int32)),
            greedy)


def test_draws_follow_the_masked_softmax():
    """Chi-square over 20,000 draws (one key per draw: row seeds 0..N-1)
    at V 16 against softmax(logits / T) renormalized over the top-p
    support; zero-probability tokens are never drawn. The threshold is
    the 0.999 quantile of chi-square with (support - 1) degrees of
    freedom."""
    gen = np.random.default_rng(3)
    V, N, T, P = 16, 20000, 1.5, 0.9
    logits = gen.standard_normal(V).astype(np.float32)
    keys = S.fold_in_rows(S.prng_key(11), torch.arange(N),
                          torch.zeros(N, dtype=torch.int64))
    toks = S.sample_tokens_rowwise(
        torch.from_numpy(logits)[None].expand(N, V), keys,
        torch.full((N,), T), torch.full((N,), P),
        torch.zeros(N, dtype=torch.int32)).numpy()
    counts = np.bincount(toks, minlength=V)

    s = logits.astype(np.float64) / T
    order = np.argsort(-s)
    p = np.exp(s[order] - s[order].max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < P
    p = np.where(keep, p, 0.0)
    p /= p.sum()
    expected = np.zeros(V)
    expected[order] = p * N
    support = expected > 0
    assert support.sum() >= 6
    assert counts[~support].sum() == 0
    chi2 = float(((counts[support] - expected[support]) ** 2
                  / expected[support]).sum())
    assert chi2 < stats.chi2.ppf(0.999, support.sum() - 1), (chi2, counts)
    # the same statistic for the generated-token axis of one row
    keys = S.fold_in_rows(S.prng_key(11), torch.zeros(N, dtype=torch.int64),
                          torch.arange(N))
    toks = S.sample_tokens_rowwise(
        torch.from_numpy(logits)[None].expand(N, V), keys,
        torch.full((N,), T), torch.full((N,), P),
        torch.zeros(N, dtype=torch.int32)).numpy()
    counts = np.bincount(toks, minlength=V)
    chi2 = float(((counts[support] - expected[support]) ** 2
                  / expected[support]).sum())
    assert chi2 < stats.chi2.ppf(0.999, support.sum() - 1), (chi2, counts)


# ---------------------------------------------------------------------------
# the engine: fused window against the per-token path
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    cfg = TransformerConfig(**dataclasses.asdict(
        dataclasses.replace(jax_tiny_test(), num_kv_heads=2)))
    model = TransformerLM(cfg)

    def build(window, params=None):
        return InferenceEngineV2(model, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(
                max_tracked_sequences=8, max_seq_len=128, num_blocks=65,
                block_size=16),
            dtype="float32", prefill_bucket=16, decode_window=window),
            params=params, device="cpu")
    e8 = build(8)
    return e8, build(1, e8.params)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 200, n))) for n in lens]


@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_p=0.9, top_k=0, seed=0),
    dict(temperature=1.2, top_p=1.0, top_k=20, seed=7),
    dict(temperature=0.6, top_p=0.7, top_k=5, seed=2 ** 40 + 3)])
def test_sampled_window_equals_per_token_path(engines, kw):
    e8, e1 = engines
    prompts = _prompts((5, 17, 33, 9, 20))
    win = e8.generate(prompts, 19, **kw)
    tok = e1.generate(prompts, 19, **kw)
    for a, b in zip(win, tok):
        np.testing.assert_array_equal(a, b)
    again = e8.generate(prompts, 19, **kw)
    for a, b in zip(win, again):
        np.testing.assert_array_equal(a, b)
    other = e8.generate(prompts, 19, **dict(kw, seed=kw["seed"] + 1))
    assert any(not np.array_equal(a, b) for a, b in zip(win, other))


def test_sampled_window_with_eos_equals_per_token_path(engines):
    """Rows that stop on their EOS mid-window stay padded in place; the
    streams still equal the per-token path's."""
    e8, e1 = engines
    prompts = _prompts((7, 12, 30), seed=1)
    kw = dict(temperature=1.5, top_p=1.0, top_k=0, seed=4)
    free = e8.generate(prompts, 24, **kw)
    # an EOS that one row emits early and another not at all
    eos = int(free[0][len(prompts[0]) + 3])
    win = e8.generate(prompts, 24, eos_token_id=eos, **kw)
    tok = e1.generate(prompts, 24, eos_token_id=eos, **kw)
    for a, b in zip(win, tok):
        np.testing.assert_array_equal(a, b)
    assert len(win[0]) == len(prompts[0]) + 4


def test_generate_sampling_syncs_once_per_window_and_top_k_one(engines):
    e8, _ = engines
    prompts = _prompts((6, 14, 25, 3))
    s0, w0 = e8.host_syncs, e8.decode_windows
    out = e8.generate(prompts, 21, temperature=0.9, top_p=0.95, top_k=40,
                      seed=5)
    windows = e8.decode_windows - w0
    assert windows == 3                 # 20 decode steps, K = 8
    assert e8.host_syncs - s0 == windows
    for p, o in zip(prompts, out):
        assert len(o) == len(p) + 21
        assert ((o >= 0) & (o < 256)).all()
    greedy = e8.generate(prompts, 21)
    k1 = e8.generate(prompts, 21, temperature=0.9, top_k=1, seed=5)
    for a, b in zip(greedy, k1):
        np.testing.assert_array_equal(a, b)
    assert e8.state_manager.free_blocks() == 64

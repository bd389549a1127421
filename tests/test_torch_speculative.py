"""PyTorch port: prompt-lookup speculative decoding in the v2 engine against
the JAX package (``tests/unit/inference/test_speculative.py``, case for
case).

One tiny fp32 model in both packages (``torch_fleet_common.Models``: its
weights drawn by JAX and moved by name), the port's engines on the CPU (the
kernels' plain versions). Held: greedy streams with ``speculative=True``
token-identical to the JAX package's speculative streams and to plain
greedy; the drafted / accepted / miss-round counters equal to JAX's;
``NGramIndex.draft`` equal to the reference scan ``_lookup_draft`` and to
the JAX index over seeded histories; the miss streak cleared between
requests and at ``flush()``; EOS and prefix caching compose; the sequence
limit holds; sampling with speculation raises JAX's AssertionError.
"""

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2.ngram_index import NGramIndex as JIndex
from deepspeed_tpu.telemetry import get_registry as jregistry

from torch_fleet_common import Models

from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.ngram_index import NGramIndex
from deepspeed_tpu_torch.telemetry import get_registry

SPEC = ("inference_spec_drafted_tokens_total",
        "inference_spec_accepted_tokens_total",
        "inference_spec_miss_rounds_total")


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def jax_engine(models):
    """One JAX engine for the module (its programs compile once); every
    generate() flushes its uids."""
    return models.jax_engine()


def _counted(reg, fn):
    """``fn()``'s result and the speculation counters' increments."""
    before = {n: reg.family_total(n) for n in SPEC}
    out = fn()
    return out, {n: reg.family_total(n) - before[n] for n in SPEC}


def _prompts(repetitive):
    if repetitive:
        unit = [5, 9, 17, 23]
        return [unit * 6, [3] + unit * 4]            # strong 4-periodicity
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(1, 127, n))) for n in (21, 34)]


def test_lookup_draft():
    f, jf = InferenceEngineV2._lookup_draft, JEngine._lookup_draft
    hist = [1, 2, 3, 9, 8, 1, 2, 3]
    assert f(hist, 2, 3) == [9, 8]
    assert f(hist, 4, 3) == [9, 8, 1, 2]
    assert f([1, 2, 3, 4, 5], 3, 3) == []
    assert f([7, 7, 5, 9, 4, 5, 9], 1, 3) == [4]
    assert InferenceEngineV2._SPEC_SCAN_WINDOW == JEngine._SPEC_SCAN_WINDOW
    rng = np.random.default_rng(3)
    for _ in range(50):
        h = list(map(int, rng.integers(0, 6, int(rng.integers(1, 60)))))
        for k, n in ((1, 2), (4, 3), (3, 4)):
            assert f(h, k, n) == jf(h, k, n), (h, k, n)


@pytest.mark.parametrize("repetitive", [True, False])
def test_speculative_matches_plain_greedy(models, jax_engine, repetitive):
    """Identical tokens with and without speculation, on text that repeats
    (drafts accept) and on random text (drafts mostly reject), equal to
    the JAX package's speculative streams, with its counters."""
    prompts = _prompts(repetitive)
    ref = models.torch_engine().generate(prompts, max_new_tokens=20)
    eng = models.torch_engine()
    out, counts = _counted(get_registry(), lambda: eng.generate(
        prompts, max_new_tokens=20, uids=[5, 6], speculative=True))
    jout, jcounts = _counted(jregistry(), lambda: jax_engine.generate(
        prompts, max_new_tokens=20, uids=[5, 6], speculative=True,
        spec_mode="ngram"))
    for a, b, c in zip(out, ref, jout):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert counts == jcounts
    if repetitive:
        assert counts["inference_spec_accepted_tokens_total"] > 0


def _count_calls(eng):
    calls = {"n": 0}
    for name in ("_decode_batch_greedy", "_speculative_step"):
        orig = getattr(eng, name)

        def counted(*a, _o=orig, **kw):
            calls["n"] += 1
            return _o(*a, **kw)

        setattr(eng, name, counted)
    return calls


def test_speculative_fewer_decode_calls_on_repetitive_text(models):
    """On periodic text the drafts accept, so the engine runs FEWER
    decode / verify passes than tokens generated."""
    prompt = [5, 9, 17, 23] * 8
    eng = models.torch_engine()
    calls = _count_calls(eng)
    out = eng.generate([prompt], max_new_tokens=16, speculative=True)[0]
    assert len(out) == len(prompt) + 16
    # plain greedy would take 15 decode steps after the prefill token
    assert calls["n"] < 12, calls


def test_speculative_eos_and_prefix_caching_compose(models, jax_engine):
    prompt = [5, 9, 17, 23] * 5
    ref = models.torch_engine().generate([prompt], max_new_tokens=12)[0]
    eos = int(ref[len(prompt) + 5])
    r2 = models.torch_engine().generate([prompt], max_new_tokens=12,
                                        eos_token_id=eos)[0]
    eng = models.torch_engine(enable_prefix_caching=True)
    out = eng.generate([prompt], max_new_tokens=12, eos_token_id=eos,
                       speculative=True, uids=[1])[0]
    np.testing.assert_array_equal(out, r2)
    # token_log rollback stayed consistent: a repeat serve reuses blocks
    out2 = eng.generate([prompt], max_new_tokens=12, eos_token_id=eos,
                        speculative=True, uids=[2])[0]
    np.testing.assert_array_equal(out2, r2)
    jout = jax_engine.generate([prompt], max_new_tokens=12,
                               eos_token_id=eos, speculative=True,
                               spec_mode="ngram", uids=[1])[0]
    np.testing.assert_array_equal(out, jout)


def test_speculative_rejects_sampling(models, jax_engine):
    eng = models.torch_engine()
    for e in (eng, jax_engine):
        with pytest.raises(AssertionError, match="greedy-only"):
            e.generate([[1, 2, 3]], max_new_tokens=4, speculative=True,
                       temperature=0.8)


def test_spec_miss_streak_reset_between_requests(models):
    """A cold streak from one request must not ban drafting for a reused
    uid: flush() forgets the uid's streak and generate() starts every
    call with a clean slate."""
    eng = models.torch_engine()
    eng._spec_miss_streak[5] = 3
    eng._draft_index[5] = NGramIndex(3, 512)
    eng.generate([[1, 2, 3]], max_new_tokens=2, uids=[5])
    assert 5 not in eng._spec_miss_streak and 5 not in eng._draft_index
    eng._spec_miss_streak[6] = 99
    calls = _count_calls(eng)
    out = eng.generate([[5, 9, 17, 23] * 8], max_new_tokens=16,
                       uids=[6], speculative=True)[0]
    assert len(out) == 32 + 16
    assert calls["n"] < 12, calls
    # a streak that reached the cutoff mid-request is dropped by flush()
    eng._spec_miss_streak[7] = 3
    eng.flush(7)
    assert 7 not in eng._spec_miss_streak


def test_speculative_respects_max_seq_len(models):
    """A late speculative round clamps its draft to the sequence budget:
    greedy-exact right up to the limit."""
    prompt = [5, 9, 17, 23] * 4 + [5]                    # 17 tokens
    sm = dict(max_tracked_sequences=2, max_seq_len=33, num_blocks=9,
              block_size=16)
    ref = models.torch_engine(**sm).generate([prompt], max_new_tokens=16)[0]
    eng = models.torch_engine(**sm)
    out = eng.generate([prompt], max_new_tokens=16, speculative=True)[0]
    np.testing.assert_array_equal(out, ref)
    assert len(out) == 33
    jout = models.jax_engine(**sm).generate([prompt], max_new_tokens=16,
                                            speculative=True)[0]
    np.testing.assert_array_equal(out, jout)


def test_ngram_index_parity_with_scan():
    """The incremental NGramIndex returns what the reference scan and the
    JAX package's index return — every prefix length, over token streams
    with heavy n-gram repetition, for several (k, ngram) shapes."""
    scan = InferenceEngineV2._lookup_draft
    W = InferenceEngineV2._SPEC_SCAN_WINDOW
    rng = np.random.default_rng(0)
    for trial, vocab in enumerate((4, 8, 64)):   # small vocab => matches
        toks = list(map(int, rng.integers(0, vocab, 400)))
        for ngram in (2, 3, 4):
            idx, jidx = NGramIndex(ngram, W), JIndex(ngram, W)
            for L in range(1, len(toks) + 1):
                idx.append(toks[L - 1])
                jidx.append(toks[L - 1])
                for k in (1, 4):
                    got = idx.draft(k, ngram)
                    assert got == jidx.draft(k, ngram), (trial, ngram, L, k)
                    if L % 7 == 0 or L > 380:
                        assert got == scan(toks[:L], k, ngram), \
                            (trial, ngram, L, k)


def test_ngram_index_window_bound_parity():
    """Occurrences older than the scan window are ignored by the index,
    the scan and the JAX index alike (a small window forces the case)."""
    hist = [1, 2, 3] + [9] * 30 + [1, 2, 3]
    W = 8

    def scan_w(history, k, ngram, window):
        saved = InferenceEngineV2._SPEC_SCAN_WINDOW
        InferenceEngineV2._SPEC_SCAN_WINDOW = window
        try:
            return InferenceEngineV2._lookup_draft(history, k, ngram)
        finally:
            InferenceEngineV2._SPEC_SCAN_WINDOW = saved

    for h, k, want in ((hist, 3, []),
                       ([9] * 30 + [1, 2, 3, 7, 1, 2, 3], 2, [7, 1])):
        idx, jidx = NGramIndex(3, W), JIndex(3, W)
        idx.extend(h)
        jidx.extend(h)
        assert idx.draft(k, 3) == jidx.draft(k, 3) == scan_w(h, k, 3, W) \
            == want


def test_ngram_index_sync_appends_only_new_tokens():
    idx = NGramIndex(3, 512)
    row = [1, 2, 3, 4]
    idx.sync(row)
    assert idx.tokens is row
    row += [5, 6, 1, 2, 3]
    idx.sync(row)
    assert idx.tokens == row
    assert idx.draft(2, 3) == InferenceEngineV2._lookup_draft(row, 2, 3) \
        == [4, 5]
    assert idx.has_candidate(3) and not NGramIndex(3, 512).has_candidate(3)

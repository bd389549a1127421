"""PyTorch port: draft-model speculative decoding inside the decode window
(``paged_model.paged_spec_decode_window``) against the JAX package
(``tests/unit/inference/test_spec_window.py``, case for case).

The tiny fp32 target of ``torch_fleet_common.Models`` and its draft models
in both packages: the target itself (a self-draft), and a 1-layer draft of
the same vocabulary whose weights JAX draws from another key (a divergent
draft), moved into the port by name. The port's engines run on the CPU
(the kernels' plain versions). Held: greedy speculative streams
token-identical to plain greedy and to the JAX package's, with the window
statistics (drafted, accepted, miss rounds, row rounds) equal to JAX's,
for both drafts, with the LoRA bank on and off; EOS, prefix caching and
the sequence limit compose; the "auto" chooser's routes and switches equal
JAX's on a mixed batch; ``DraftModelMismatchError`` for a vocabulary or a
sequence range the draft cannot share; ``spec_mode`` validation raises
JAX's exception types; the telemetry names and the chooser's hysteresis.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.inference.v2.engine_v2 import \
    DraftModelMismatchError as JMismatch
from deepspeed_tpu.inference.v2.engine_v2 import SpecChooser as JChooser
from deepspeed_tpu.models import TransformerConfig as JTConfig
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.telemetry import get_registry as jregistry

from torch_fleet_common import SM, Models

from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import (
    DraftModelMismatchError, SpecChooser)
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.telemetry import get_registry

STATS = ("inference_spec_drafted_tokens_total",
         "inference_spec_accepted_tokens_total",
         "inference_spec_miss_rounds_total",
         "inference_spec_window_rounds_total")
LORA = dict(max_lora_adapters=2, lora_rank=4)


class Drafts:
    """The divergent 1-layer draft in both packages (JAX's draw)."""

    def __init__(self):
        self.jcfg = JTConfig(vocab_size=128, hidden_size=32,
                             intermediate_size=64, num_layers=1, num_heads=2,
                             num_kv_heads=2, max_seq_len=256, remat=False,
                             use_flash=False)
        self.jmodel = JModel(self.jcfg)
        self.np_params = jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)),
            self.jmodel.init_params(jax.random.PRNGKey(7)))
        self.tmodel = TransformerLM(
            TransformerConfig(**dataclasses.asdict(self.jcfg)))
        self.tparams = params_from_numpy(self.np_params)


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.fixture(scope="module")
def drafts():
    return Drafts()


def _jax(models, draft=None, lora=False, **sm):
    e = JEngine(models.jmodel, JConfig(
        state_manager=JSM(**dict(SM, **sm)), dtype="float32",
        prefill_bucket=16, **(LORA if lora else {})),
        params=models.np_params)
    if draft == "self":
        e.load_draft_model(models.jmodel, models.np_params)
    elif draft is not None:
        e.load_draft_model(draft.jmodel, draft.np_params)
    return e


def _torch(models, draft=None, lora=False, **sm):
    e = InferenceEngineV2(models.tmodel, RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(**dict(SM, **sm)),
        dtype="float32", prefill_bucket=16, **(LORA if lora else {})),
        params=models.tparams, device="cpu")
    if draft == "self":
        e.load_draft_model(models.tmodel, models.tparams)
    elif draft is not None:
        e.load_draft_model(draft.tmodel, draft.tparams)
    return e


@pytest.fixture(scope="module")
def jax_self(models):
    """One self-draft JAX engine for the module's pinned-mode cases (its
    programs compile once)."""
    return _jax(models, "self")


def _prompts(repetitive):
    if repetitive:
        unit = [5, 9, 17, 23]
        return [unit * 6, [3] + unit * 4]
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(1, 127, n))) for n in (21, 34)]


def _counted(reg, fn):
    before = {n: reg.family_total(n) for n in STATS}
    out = fn()
    return out, {n: reg.family_total(n) - before[n] for n in STATS}


def _both(teng, jeng, prompts, new, **kw):
    """The port's and JAX's streams and window statistics for one
    generate() call."""
    out, stats = _counted(get_registry(), lambda: teng.generate(
        prompts, max_new_tokens=new, **kw))
    jout, jstats = _counted(jregistry(), lambda: jeng.generate(
        prompts, max_new_tokens=new, **kw))
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a, b)
    assert stats == jstats, (stats, jstats)
    return out, stats


def _adapters(cfg, seed, scale=0.6, rank=4):
    from deepspeed_tpu_torch.models.transformer import lora_target_leaves
    rng = np.random.default_rng(seed)
    return {p: (rng.normal(size=(cfg.num_layers, i, rank))
                .astype(np.float32) * scale,
                rng.normal(size=(cfg.num_layers, rank, o))
                .astype(np.float32) * scale)
            for p, (i, o) in lora_target_leaves(cfg).items()}


# ---------------------------------------------------------------------------
# parity: equal to plain greedy and to JAX, for every draft quality
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("repetitive", [True, False])
def test_draft_spec_greedy_bit_identical(models, jax_self, repetitive):
    """Self-draft (draft == target weights): near-total acceptance, and
    the output is still the plain greedy stream, with JAX's stats."""
    prompts = _prompts(repetitive)
    ref = models.torch_engine().generate(prompts, max_new_tokens=20)
    eng = _torch(models, "self")
    out, stats = _both(eng, jax_self, prompts, 20, uids=[5, 6],
                       speculative=True, spec_mode="draft")
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert stats["inference_spec_window_rounds_total"] > 0
    assert eng.spec_windows > 0 and eng.spec_rounds > 0


@pytest.mark.parametrize("lora", [False, True])
def test_divergent_draft_still_bit_identical(models, drafts, lora):
    """A draft of other weights disagrees with the target almost
    everywhere: verification rejects its proposals, the stream stays the
    plain greedy one, and the window stats are JAX's. With the LoRA bank
    on, rows served through an adapter verify with their deltas."""
    prompts = _prompts(True) + _prompts(False)
    teng, jeng = _torch(models, drafts, lora), _jax(models, drafts, lora)
    kw = {}
    if lora:
        ada = _adapters(models.tcfg, 1)
        teng.load_adapter("a", ada)
        jeng.load_adapter("a", ada)
        kw["adapter"] = ["a", None, "a", None]
        plain = _torch(models, lora=True)
        plain.load_adapter("a", ada)
        ref = plain.generate(prompts, max_new_tokens=16, **kw)
    else:
        ref = models.torch_engine().generate(prompts, max_new_tokens=16)
    out, stats = _both(teng, jeng, prompts, 16, speculative=True,
                       spec_mode="draft", **kw)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert stats["inference_spec_miss_rounds_total"] > 0


def test_self_draft_with_lora_bank(models):
    """The self-draft with the bank on: base rows accept everything the
    budget lets through, adapter rows (whose target differs from the
    bank-less draft) are still the plain greedy stream, with JAX's
    stats."""
    prompts = _prompts(True)
    ada = _adapters(models.tcfg, 2)
    teng, jeng = _torch(models, "self", True), _jax(models, "self", True)
    plain = _torch(models, lora=True)
    for e in (teng, jeng, plain):
        e.load_adapter("a", ada)
    ref = plain.generate(prompts, max_new_tokens=16, adapter=[None, "a"])
    out, _ = _both(teng, jeng, prompts, 16, speculative=True,
                   spec_mode="draft", adapter=[None, "a"])
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_draft_spec_eos_and_prefix_caching_compose(models):
    prompt = [5, 9, 17, 23] * 5
    ref = models.torch_engine().generate([prompt], max_new_tokens=12)[0]
    eos = int(ref[len(prompt) + 5])
    r2 = models.torch_engine().generate([prompt], max_new_tokens=12,
                                        eos_token_id=eos)[0]
    eng = _torch(models, "self", enable_prefix_caching=True)
    jeng = _jax(models, "self", enable_prefix_caching=True)
    out, _ = _both(eng, jeng, [prompt], 12, eos_token_id=eos,
                   speculative=True, spec_mode="draft", uids=[1])
    np.testing.assert_array_equal(out[0], r2)
    # repeat serve: the spec window's token_log kept the prefix cache
    # consistent, so a fresh uid reuses blocks and stays identical
    out2 = eng.generate([prompt], max_new_tokens=12, eos_token_id=eos,
                        speculative=True, spec_mode="draft", uids=[2])[0]
    np.testing.assert_array_equal(out2, r2)


def test_draft_spec_respects_max_seq_len(models):
    """A late window clamps its draft to the sequence budget (rows that
    run out of room take the plain greedy step inside the round):
    greedy-exact right up to the limit."""
    prompt = [5, 9, 17, 23] * 4 + [5]                    # 17 tokens
    sm = dict(max_tracked_sequences=2, max_seq_len=33, num_blocks=9,
              block_size=16)
    ref = models.torch_engine(**sm).generate([prompt], max_new_tokens=16)[0]
    out, _ = _both(_torch(models, "self", **sm), _jax(models, "self", **sm),
                   [prompt], 16, speculative=True, spec_mode="draft")
    np.testing.assert_array_equal(out[0], ref)
    assert len(out[0]) == 33


def test_auto_mode_mixed_batch_parity(models):
    """spec_mode None ("auto"): the chooser routes each request alone — a
    repetitive prompt (n-gram prior) and a random one (draft prior) share
    a batch, both stay greedy-exact, and the routes, rates and switches
    over two calls are JAX's."""
    prompts = [_prompts(True)[0], _prompts(False)[0]]
    ref = models.torch_engine().generate(prompts, max_new_tokens=16)
    teng, jeng = _torch(models, "self"), _jax(models, "self")
    mode = "inference_spec_mode_requests_total"
    for call in range(2):
        before = {md: get_registry().get(mode).labels(mode=md).value
                  for md in ("ngram", "draft")}
        jbefore = {md: jregistry().get(mode).labels(mode=md).value
                   for md in ("ngram", "draft")}
        out, _ = _both(teng, jeng, prompts, 16, speculative=True)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        routed = {md: get_registry().get(mode).labels(mode=md).value
                  - before[md] for md in before}
        jrouted = {md: jregistry().get(mode).labels(mode=md).value
                   - jbefore[md] for md in jbefore}
        assert routed == jrouted, (call, routed, jrouted)
        if call == 0:
            # cold start: the periodic prompt routes to its own history,
            # the random one to the draft model
            assert routed == {"ngram": 1, "draft": 1}, routed
        tc, jc = teng.spec_chooser, jeng.spec_chooser
        assert (tc.current, tc.switches, tc._armed, tc._streak) == \
            (jc.current, jc.switches, jc._armed, jc._streak)
        for md in ("ngram", "draft"):
            assert (tc.rate[md] is None) == (jc.rate[md] is None)
            if tc.rate[md] is not None:
                assert tc.rate[md] == pytest.approx(jc.rate[md], abs=1e-12)


# ---------------------------------------------------------------------------
# typed rejection + request validation
# ---------------------------------------------------------------------------
def _other(pkg, **kw):
    cfg = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
               num_layers=1, num_heads=2, num_kv_heads=2, max_seq_len=256,
               remat=False, use_flash=False)
    cfg.update(kw)
    return (JModel(JTConfig(**cfg)) if pkg == "jax"
            else TransformerLM(TransformerConfig(**cfg)))


@pytest.mark.parametrize("bad,match", [(dict(vocab_size=64), "vocab_size"),
                                       (dict(max_seq_len=64),
                                        "max_seq_len")])
def test_draft_mismatch_typed(models, bad, match):
    msgs = []
    for pkg, eng, exc in (("torch", _torch(models), DraftModelMismatchError),
                          ("jax", _jax(models), JMismatch)):
        with pytest.raises(exc, match=match) as e:
            eng.load_draft_model(_other(pkg, **bad))
        assert eng.draft_model is None
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # a ValueError: callers with the generic typed-failure handler work
    assert issubclass(DraftModelMismatchError, ValueError)


def test_spec_mode_validation(models):
    teng, jeng = _torch(models), _jax(models)
    for kw, exc, match in ((dict(spec_mode="draft"), ValueError,
                            "load_draft_model"),
                           (dict(spec_mode="bogus"), ValueError, "auto"),
                           (dict(temperature=0.8), AssertionError,
                            "greedy-only")):
        msgs = []
        for eng in (teng, jeng):
            with pytest.raises(exc, match=match) as e:
                eng.generate([[1, 2, 3]], max_new_tokens=4,
                             speculative=True, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # no draft model + auto: everything falls back to n-gram, greedy-exact
    ref = models.torch_engine().generate([[5, 9, 17, 23] * 5],
                                         max_new_tokens=8)
    out = teng.generate([[5, 9, 17, 23] * 5], max_new_tokens=8,
                        speculative=True)
    np.testing.assert_array_equal(out[0], ref[0])
    # the config's mode is the chooser's
    pinned = InferenceEngineV2(models.tmodel, RaggedInferenceEngineConfig(
        state_manager=DSStateManagerConfig(**SM), dtype="float32",
        spec_mode="draft"), params=models.tparams, device="cpu")
    assert pinned.spec_chooser.mode == "draft"
    assert pinned.spec_chooser.current == "draft"


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------
def test_spec_window_telemetry(models, jax_self):
    eng = _torch(models, "self")
    names = STATS + ("inference_spec_mode_requests_total",
                     "inference_spec_chooser_switches_total",
                     "inference_spec_accept_rate")
    for n in names:
        t, j = get_registry().get(n), jregistry().get(n)
        assert t is not None and j is not None, n
        assert (type(t).__name__, t.help, tuple(t.labelnames)) == \
            (type(j).__name__, j.help, tuple(j.labelnames)), n
    (_, stats) = _counted(get_registry(), lambda: eng.generate(
        [[5, 9, 17, 23] * 6], max_new_tokens=12, speculative=True,
        spec_mode="draft"))
    drafted = stats["inference_spec_drafted_tokens_total"]
    accepted = stats["inference_spec_accepted_tokens_total"]
    assert drafted > 0 and stats["inference_spec_window_rounds_total"] > 0
    # self-draft: every verified token matches; the rate is below 1.0
    # only because the last round's proposals are cut by the budget
    assert accepted / drafted > 0.5, (accepted, drafted)
    rate = get_registry().get("inference_spec_accept_rate").labels(
        mode="draft").value
    assert rate > 0.5


# ---------------------------------------------------------------------------
# chooser hysteresis (armed / hold, like autotuning/online.py)
# ---------------------------------------------------------------------------
def test_chooser_hysteresis_margin_and_hold():
    def state(ch):
        return (ch.current, ch.switches, ch._armed, ch._streak,
                dict(ch.rate))

    rng = np.random.default_rng(5)
    for alpha, margin, hold in ((1.0, 0.05, 3), (0.3, 0.05, 3),
                                (1.0, 0.2, 1), (0.5, 0.0, 2)):
        ch = SpecChooser("auto", alpha, margin, hold)
        jch = JChooser("auto", alpha, margin, hold)
        assert ch.choose(True, True) == jch.choose(True, True) == "ngram"
        assert ch.choose(True, False) == jch.choose(True, False) == "draft"
        for _ in range(60):
            mode = ("ngram", "draft")[int(rng.integers(2))]
            drafted = int(rng.integers(0, 11))
            accepted = int(rng.integers(0, drafted + 1))
            ch.observe(mode, drafted, accepted)
            jch.observe(mode, drafted, accepted)
            assert state(ch) == state(jch)
            for args in ((True, True), (True, False), (False, False)):
                assert ch.choose(*args) == jch.choose(*args)
    # the JAX test's script: a switch commits only after HOLD winning
    # observations, a broken streak disarms
    ch = SpecChooser(mode="auto", alpha=1.0, margin=0.05, hold=3)
    ch.observe("ngram", drafted=10, accepted=3)
    ch.observe("draft", drafted=10, accepted=9)
    ch.observe("draft", drafted=10, accepted=9)
    assert ch.current == "ngram" and ch.switches == 0
    ch.observe("draft", drafted=10, accepted=9)
    assert ch.current == "draft" and ch.switches == 1
    assert SpecChooser(mode="draft").choose(True, False) == "draft"
    assert SpecChooser(mode="ngram").choose(True, False) == "ngram"
    ch.observe("draft", 0, 0)        # zero drafted rounds are ignored
    assert ch.rate["draft"] == 0.9

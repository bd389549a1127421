"""PPO learner: rollout queue -> GAE -> bucketed pack -> train step (port
of ``deepspeed_tpu/rl/learner.py``).

Rollouts live in the ragged host layout (variable-length token / logprob
lists, one :class:`RolloutSample` each); the engine wants fixed
``[gas, global_micro, S]`` arrays. :meth:`PPOLearner.pack` bridges them:

* advantages / returns per sample on the host (:func:`~.advantage.gae`);
* samples packed into ``gas * global_micro`` rows with the sequence axis
  pow2-bucketed (``utils/bucketing.pow2_bucket``, capped at the model's
  ``max_seq_len``), so a learner batch has few distinct shapes;
* the packed batch carries ``ppo_*`` keys, which route ``model.apply`` to
  the clipped-PPO + KL objective (``models/transformer.py``); the KL term
  reuses the logprobs recorded at rollout time (no reference forward).

:meth:`PPOLearner.step` then calls the engine's own ``train_batch``: its
gradient reduction, fp16 loss scaling and quantized-reduce state apply
as to any batch (on the card, at S >= ``flash_min_seq``, through the
flash kernels).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..runtime.hybrid_engine import RolloutSample
from ..utils.bucketing import pow2_bucket
from .advantage import gae, whiten


def _token_rewards(sample: RolloutSample) -> np.ndarray:
    """Per-generated-token reward vector: a scalar ``reward`` lands on
    the final token (the standard sequence-reward RLHF shape); a list
    must match the generated length; None is all-zero."""
    T = len(sample.tokens)
    r = np.zeros(T, np.float32)
    if sample.reward is None:
        return r
    if np.ndim(sample.reward) == 0:
        if T:
            r[-1] = float(sample.reward)
        return r
    rw = np.asarray(sample.reward, np.float32).reshape(-1)
    if rw.shape[0] != T:
        raise ValueError(
            f"per-token reward length {rw.shape[0]} != generated "
            f"length {T}")
    return rw


class PPOLearner:
    """Drains :class:`~..runtime.hybrid_engine.RolloutQueue`
    minibatches and turns each into one engine train step under the
    clipped-PPO objective.

    ``engine`` is any :class:`~..runtime.engine.DeepSpeedTpuEngine`
    (usually the :class:`~..runtime.hybrid_engine.
    DeepSpeedHybridEngine`, whose ``rollout_queue`` is the default
    queue). ``value_fn(sample) -> [T] values`` optionally plugs a
    critic; without one GAE degrades to discounted reward-to-go.
    ``min_samples`` is the backpressure floor: :meth:`step` declines
    (returns None) until the queue's lock-free ``depth`` reaches it.
    """

    def __init__(self, engine, queue=None, gamma: float = 0.99,
                 lam: float = 0.95, clip_eps: float = 0.2,
                 kl_coef: float = 0.1, whiten_advantages: bool = True,
                 min_samples: int = 1, min_bucket: int = 8,
                 value_fn=None):
        self.engine = engine
        self.queue = queue if queue is not None \
            else getattr(engine, "rollout_queue", None)
        self.gamma = float(gamma)
        self.lam = float(lam)
        self.clip_eps = float(clip_eps)
        self.kl_coef = float(kl_coef)
        self.whiten_advantages = bool(whiten_advantages)
        self.min_samples = max(int(min_samples), 1)
        self.min_bucket = max(int(min_bucket), 1)
        self.value_fn = value_fn
        self.steps = 0
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_steps = reg.counter(
            "rl_learner_steps_total",
            "PPO learner train steps completed")
        self._m_samples = reg.counter(
            "rl_learner_samples_total",
            "rollout samples consumed by learner steps")
        self._m_tokens = reg.counter(
            "rl_learner_tokens_total",
            "generated tokens consumed by learner steps")
        self._m_pad = reg.gauge(
            "rl_learner_pad_fraction",
            "padding fraction of the newest packed learner batch "
            "(bucketed rows x seq vs real prompt+generated tokens)")
        self._m_adv_mean = reg.gauge(
            "rl_advantage_mean",
            "mean GAE advantage over the newest batch's generated "
            "tokens (pre-whitening)")
        self._m_adv_std = reg.gauge(
            "rl_advantage_std",
            "std of GAE advantages over the newest batch's generated "
            "tokens (pre-whitening)")
        self._m_staleness = reg.gauge(
            "rl_sample_staleness_steps",
            "mean publish-version lag of the newest batch's samples "
            "(current weight_version minus the version that generated "
            "them)")

    # -- geometry --------------------------------------------------------
    @property
    def rows(self) -> int:
        """Rows one learner step feeds the engine: gas * global_micro —
        the exact batch geometry ``engine._shard_batch`` requires."""
        eng = self.engine
        return int(eng.gas * eng.micro_batch_size
                   * eng.ds_config.dp_world_size)

    def _seq_cap(self) -> int:
        cfg = getattr(self.engine.model, "cfg", None)
        return int(getattr(cfg, "max_seq_len", 0) or (1 << 30))

    # -- packing (ragged rollout layout -> the engine's batch layout) -----
    def pack(self, samples: List[RolloutSample]
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
        """Pack up to ``rows`` samples into one pow2-length-bucketed
        PPO batch (missing rows are all-pad: loss_mask 0 contributes
        nothing to the masked mean). Returns ``(batch, stats)``."""
        rows = self.rows
        if not samples:
            raise ValueError("pack needs at least one rollout sample")
        if len(samples) > rows:
            raise ValueError(
                f"{len(samples)} samples > {rows} mesh rows; pop at "
                f"most `rows` samples per step")
        cap = self._seq_cap()
        max_len = max(len(s.prompt) + len(s.tokens) for s in samples)
        if max_len > cap:
            raise ValueError(
                f"rollout length {max_len} exceeds the model's "
                f"max_seq_len {cap}")
        S = pow2_bucket(max(max_len, self.min_bucket), cap)
        ids = np.zeros((rows, S), np.int64)
        mask = np.zeros((rows, S), np.float32)
        old_lp = np.zeros((rows, S), np.float32)
        adv = np.zeros((rows, S), np.float32)
        version = int(getattr(self.engine, "weight_version", 0) or 0)
        real_tokens = 0
        gen_tokens = 0
        staleness: List[int] = []
        adv_flat: List[np.ndarray] = []
        for i, s in enumerate(samples):
            seq = list(s.prompt) + list(s.tokens)
            L, p, T = len(seq), len(s.prompt), len(s.tokens)
            if len(s.logprobs) != T:
                raise ValueError(
                    f"sample {i}: {len(s.logprobs)} logprobs != {T} "
                    f"generated tokens")
            ids[i, :L] = seq
            real_tokens += L
            gen_tokens += T
            staleness.append(max(version - int(s.weight_version), 0))
            if not T:
                continue
            dones = np.zeros(T, np.float32)
            if s.done:
                dones[-1] = 1.0
            values = self.value_fn(s) if self.value_fn is not None \
                else None
            a, _ = gae(_token_rewards(s), values=values, dones=dones,
                       gamma=self.gamma, lam=self.lam)
            mask[i, p:L] = 1.0
            old_lp[i, p:L] = np.asarray(s.logprobs, np.float32)
            adv[i, p:L] = a
            adv_flat.append(a)
        all_adv = (np.concatenate(adv_flat) if adv_flat
                   else np.zeros(1, np.float32))
        stats = {
            "samples": len(samples),
            "tokens": gen_tokens,
            "seq_bucket": int(S),
            "pad_fraction": 1.0 - real_tokens / float(rows * S),
            "advantage_mean": float(all_adv.mean()),
            "advantage_std": float(all_adv.std()),
            "staleness_mean": float(np.mean(staleness)),
            "staleness_max": int(max(staleness)),
        }
        if self.whiten_advantages:
            adv = whiten(adv, mask)
        batch = {
            "input_ids": ids,
            "loss_mask": mask,
            "ppo_old_logprobs": old_lp,
            "ppo_advantages": adv,
            # the hyperparams as batch data, tiled per row: tuning them
            # mid-run never changes the batch structure
            "ppo_hparams": np.tile(
                np.asarray([self.clip_eps, self.kl_coef], np.float32),
                (rows, 1)),
        }
        return batch, stats

    # -- one learner step ------------------------------------------------
    def step(self, samples: Optional[List[RolloutSample]] = None
             ) -> Optional[Dict[str, float]]:
        """One PPO update: pop a minibatch (unless given one), pack,
        and run the engine's train step. Returns the step's
        ``{"loss", ...stats}`` or None when backpressure declines
        (queue depth below ``min_samples``)."""
        if samples is None:
            if self.queue is None:
                raise ValueError(
                    "no rollout queue: pass samples= or build the "
                    "learner on a hybrid engine")
            # lock-free backpressure read (RolloutQueue.depth) — the
            # train thread never contends the actor's push lock just
            # to decide "not yet"
            if self.queue.depth < self.min_samples:
                return None
            samples = self.queue.pop(self.rows)
            if not samples:
                return None
        batch, stats = self.pack(samples)
        loss = float(self.engine.train_batch(batch=batch))
        self.steps += 1
        self._m_steps.inc()
        self._m_samples.inc(stats["samples"])
        self._m_tokens.inc(stats["tokens"])
        self._m_pad.set(stats["pad_fraction"])
        self._m_adv_mean.set(stats["advantage_mean"])
        self._m_adv_std.set(stats["advantage_std"])
        self._m_staleness.set(stats["staleness_mean"])
        return dict(loss=loss, **stats)

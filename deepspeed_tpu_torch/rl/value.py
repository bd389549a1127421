"""Critic value head for the PPO learner — a host-side fitted baseline
(port of ``deepspeed_tpu/rl/value.py``, plain numpy).

A small ridge-regression value head over cheap per-token features, fit on
the discounted returns of the rollouts the loop already paid for, plugged
into :class:`~.learner.PPOLearner`'s ``value_fn`` hook. A linear head
needs no device memory and no second transformer forward; it updates
online from sufficient statistics (``X'X`` / ``X'y`` accumulate across
:meth:`CriticValueHead.observe` calls, one solve a refit).

Features per generated token ``t`` of a ``T``-token rollout: bias,
position fraction, remaining fraction, the rollout-time policy logprob
(clipped, so a -inf from a forced token cannot blow up the normal
equations) and the running mean logprob. Targets are the discounted
return-to-go of the sample's rewards. Until ``min_samples`` rewarded
rollouts have been observed the head predicts zero, which is the
``value_fn=None`` learner exactly.
"""

from typing import List, Optional

import numpy as np

from ..runtime.hybrid_engine import RolloutSample
from .learner import _token_rewards

_FEATURES = 5
_LOGPROB_CLIP = 20.0


class CriticValueHead:
    """Ridge-regression value head: ``observe(samples)`` accumulates
    fit statistics, ``critic(sample)`` returns ``[T]`` float32 values
    for the learner's ``value_fn`` hook."""

    def __init__(self, gamma: float = 0.99, l2: float = 1e-2,
                 min_samples: int = 4):
        self.gamma = float(gamma)
        self.l2 = float(l2)
        self.min_samples = max(int(min_samples), 1)
        self._xtx = np.zeros((_FEATURES, _FEATURES), np.float64)
        self._xty = np.zeros(_FEATURES, np.float64)
        self._w: Optional[np.ndarray] = None
        self.observed = 0
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_observed = reg.counter(
            "rl_critic_observed_samples_total",
            "rewarded rollout samples folded into the critic value "
            "head's fit statistics")
        self._m_mse = reg.gauge(
            "rl_critic_fit_mse",
            "mean squared error of the critic value head against the "
            "discounted returns of the newest observed batch")

    # -- features --------------------------------------------------------
    def features(self, sample: RolloutSample) -> np.ndarray:
        """``[T, F]`` float64 feature matrix for one rollout."""
        T = len(sample.tokens)
        lp = np.clip(np.asarray(sample.logprobs, np.float64),
                     -_LOGPROB_CLIP, 0.0) if T else np.zeros(0)
        t = np.arange(T, dtype=np.float64)
        x = np.empty((T, _FEATURES), np.float64)
        x[:, 0] = 1.0
        x[:, 1] = (t + 1.0) / max(T, 1)
        x[:, 2] = (T - t) / max(T, 1)
        x[:, 3] = lp
        x[:, 4] = (np.cumsum(lp) / (t + 1.0)) if T else lp
        return x

    def returns(self, sample: RolloutSample) -> np.ndarray:
        """Discounted return-to-go ``G_t = r_t + gamma * G_{t+1}`` of
        the sample's per-token rewards (the regression targets)."""
        r = _token_rewards(sample)
        g = np.zeros_like(r)
        acc = np.float32(0.0)
        for t in range(r.shape[0] - 1, -1, -1):
            acc = r[t] + np.float32(self.gamma) * acc
            g[t] = acc
        return g

    # -- fitting ---------------------------------------------------------
    def observe(self, samples: List[RolloutSample]) -> int:
        """Fold rewarded rollouts into the fit statistics and refit.
        Returns how many samples were used (unrewarded / empty ones
        are skipped — a zero target teaches the head nothing)."""
        used = 0
        err_sq = n_tok = 0.0
        for s in samples:
            if not len(s.tokens) or s.reward is None:
                continue
            x = self.features(s)
            y = self.returns(s).astype(np.float64)
            self._xtx += x.T @ x
            self._xty += x.T @ y
            used += 1
            if self._w is not None:
                e = x @ self._w - y
                err_sq += float(e @ e)
                n_tok += y.shape[0]
        if used:
            self.observed += used
            self._m_observed.inc(used)
        if self.observed >= self.min_samples:
            reg = self._xtx + self.l2 * np.eye(_FEATURES)
            try:
                self._w = np.linalg.solve(reg, self._xty)
            except np.linalg.LinAlgError:
                self._w = None   # stay at the zero baseline
        if n_tok:
            self._m_mse.set(err_sq / n_tok)
        return used

    # -- the value_fn hook -----------------------------------------------
    def __call__(self, sample: RolloutSample) -> np.ndarray:
        """``[T]`` float32 values — zeros until the head is fit, which
        reproduces the critic-less learner bit-for-bit."""
        T = len(sample.tokens)
        if self._w is None or not T:
            return np.zeros(T, np.float32)
        return (self.features(sample) @ self._w).astype(np.float32)

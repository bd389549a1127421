"""Generalized Advantage Estimation — pure numpy host math (port of
``deepspeed_tpu/rl/advantage.py``, the same float32 operations, so the
values are bit-equal).

The learner computes advantages per rollout (variable-length reward
sequences) on the host before packing them into the train batch. GAE
(Schulman et al. 2015): with td error
``delta_t = r_t + gamma * (1 - done_t) * V_{t+1} - V_t``, the advantage is
``A_t = delta_t + gamma * lam * (1 - done_t) * A_{t+1}`` and the return
``A_t + V_t``. ``values=None`` means V == 0 everywhere: GAE(lam) becomes
the discounted reward-to-go with ``gamma * lam``.
"""

from typing import Optional, Tuple

import numpy as np


def gae(rewards, values: Optional[np.ndarray] = None,
        dones: Optional[np.ndarray] = None, gamma: float = 0.99,
        lam: float = 0.95) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sequence GAE.

    ``rewards`` [T]; ``values`` None, [T] (zero bootstrap past the
    end) or [T+1] (explicit bootstrap value); ``dones`` optional [T]
    booleans (1 truncates the accumulation — no value flows across an
    episode boundary). Returns ``(advantages [T], returns [T])``
    float32.
    """
    r = np.asarray(rewards, np.float32).reshape(-1)
    T = r.shape[0]
    if values is None:
        v = np.zeros(T + 1, np.float32)
    else:
        v = np.asarray(values, np.float32).reshape(-1)
        if v.shape[0] == T:
            v = np.concatenate([v, np.zeros(1, np.float32)])
        elif v.shape[0] != T + 1:
            raise ValueError(
                f"values must be length T or T+1 (T={T}, got "
                f"{v.shape[0]})")
    if dones is None:
        nonterminal = np.ones(T, np.float32)
        if T:
            nonterminal[-1] = 0.0   # the rollout ends the episode
    else:
        d = np.asarray(dones).reshape(-1)
        if d.shape[0] != T:
            raise ValueError(
                f"dones must be length T (T={T}, got {d.shape[0]})")
        nonterminal = 1.0 - d.astype(np.float32)
    adv = np.zeros(T, np.float32)
    acc = np.float32(0.0)
    for t in range(T - 1, -1, -1):
        delta = r[t] + np.float32(gamma) * nonterminal[t] * v[t + 1] \
            - v[t]
        acc = delta + np.float32(gamma) * np.float32(lam) \
            * nonterminal[t] * acc
        adv[t] = acc
    return adv, adv + v[:T]


def whiten(x: np.ndarray, mask: Optional[np.ndarray] = None,
           eps: float = 1e-8) -> np.ndarray:
    """Normalize ``x`` to zero mean / unit std over the masked
    positions (the standard PPO advantage whitening — variance
    reduction across the packed batch). Unmasked positions come back
    zeroed; fewer than two masked positions returns centered values
    (std of a single advantage is meaningless)."""
    x = np.asarray(x, np.float32)
    if mask is None:
        m = np.ones_like(x)
    else:
        m = np.asarray(mask, np.float32)
    n = m.sum()
    if n < 1:
        return np.zeros_like(x)
    mean = (x * m).sum() / n
    centered = (x - mean) * m
    if n < 2:
        return centered
    std = np.sqrt((centered ** 2).sum() / n)
    return centered / (std + np.float32(eps))

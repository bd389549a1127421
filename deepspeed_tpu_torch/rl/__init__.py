"""RLHF learner subsystem: port of ``deepspeed_tpu/rl`` (plain numpy host
math over the port's engines).

The hybrid engine (``runtime/hybrid_engine.py``) is the actor half:
train -> publish -> ``rollout()`` feeds a bounded ``RolloutQueue`` with
per-token policy logprobs. This package is the learner half:

* :mod:`~.advantage` — GAE advantages / returns and whitening, float32
  numpy, bit-equal to the JAX package's;
* :mod:`~.learner` — :class:`PPOLearner`: drains queue minibatches,
  computes GAE on the host, packs the ragged rollouts into the engine's
  ``[gas, global_micro, S]`` layout (pow2 length buckets) and runs the
  clipped-PPO + KL loss through the engine's own ``train_batch``;
* :mod:`~.loop` — :class:`ActorLearnerLoop`: rollout -> reward -> learn
  -> publish-every-N as an int8 weight delta, with staleness gauges;
* :mod:`~.value` — :class:`CriticValueHead`: a host ridge-regression value
  baseline for the learner's ``value_fn`` hook.
"""

from .advantage import gae, whiten
from .learner import PPOLearner
from .loop import ActorLearnerLoop
from .value import CriticValueHead

__all__ = ["gae", "whiten", "PPOLearner", "ActorLearnerLoop",
           "CriticValueHead"]

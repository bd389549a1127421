"""Actor-learner loop: rollout -> reward -> learn -> publish-every-N
(port of ``deepspeed_tpu/rl/loop.py``).

One :class:`ActorLearnerLoop` iteration is the RLHF cadence on one hybrid
engine (``runtime/hybrid_engine.py``):

1. **rollout** — ``engine.rollout(prompts, allow_stale=True, ...)``
   generates from the last published weights and pushes the samples into
   the bounded rollout queue;
2. **reward** — the user's ``reward_fn`` scores the fresh samples; the
   rewards are written onto the same :class:`RolloutSample` objects the
   queue holds;
3. **learn** — :class:`~.learner.PPOLearner` pops a minibatch and runs one
   clipped-PPO train step (or declines under backpressure);
4. **publish** — every ``publish_every`` iterations the loop publishes an
   int8 weight delta (``DeepSpeedHybridEngine.publish_delta``); between
   publishes ``rl_loop_publish_staleness_steps`` counts the learner steps
   the serving weights lag.

Fleet fan-out stays with the caller: push a returned publication with
``await router.push_weights(pub)`` (the router sends the delta to replicas
at its base version and the full payload to the others).
"""

from typing import Callable, List, Optional, Sequence

from ..runtime.hybrid_engine import RolloutSample, WeightPublication
from .learner import PPOLearner

RewardFn = Callable[[List[RolloutSample]], Sequence[float]]
PromptsFn = Callable[[int], Sequence[Sequence[int]]]


class ActorLearnerLoop:
    """Single-process actor-learner loop over a hybrid engine.

    ``reward_fn(samples) -> per-sample rewards`` (scalar per sample, or
    a per-token list per sample); ``prompts_fn(iteration) -> prompts``
    supplies each round's prompt batch. ``learner`` takes a prebuilt
    :class:`PPOLearner`; otherwise one is built from
    ``**learner_kwargs``. ``critic`` plugs a
    :class:`~.value.CriticValueHead` (or anything with
    ``observe(samples)`` + ``__call__(sample) -> [T] values``): the
    loop feeds it each round's rewarded samples BEFORE the learner
    step and — unless ``learner_kwargs`` pins its own ``value_fn`` —
    installs it as the learner's value hook, so GAE runs against
    fitted values instead of the reward-to-go degenerate case.
    ``rollout_kwargs`` are forwarded to ``engine.rollout``
    (max_new_tokens, temperature, seed, ...).
    """

    def __init__(self, engine, reward_fn: RewardFn,
                 prompts_fn: PromptsFn, publish_every: int = 4,
                 learner: Optional[PPOLearner] = None,
                 critic=None, rollout_kwargs: Optional[dict] = None,
                 **learner_kwargs):
        if publish_every < 1:
            raise ValueError(
                f"publish_every must be >= 1, got {publish_every}")
        self.engine = engine
        self.reward_fn = reward_fn
        self.prompts_fn = prompts_fn
        self.publish_every = int(publish_every)
        self.critic = critic
        if critic is not None and learner is None:
            learner_kwargs.setdefault("value_fn", critic)
        self.learner = learner if learner is not None \
            else PPOLearner(engine, **learner_kwargs)
        self.rollout_kwargs = dict(rollout_kwargs or {})
        self.iterations = 0
        self.publishes = 0
        self._steps_since_publish = 0
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_iters = reg.counter(
            "rl_loop_iterations_total",
            "actor-learner loop iterations completed")
        self._m_publishes = reg.counter(
            "rl_loop_publishes_total",
            "weight publications issued by the actor-learner loop")
        self._m_staleness = reg.gauge(
            "rl_loop_publish_staleness_steps",
            "learner steps taken since the last weight publication "
            "(how stale the acting policy is, in optimizer steps)")

    def _apply_rewards(self, samples: List[RolloutSample]) -> None:
        rewards = self.reward_fn(samples)
        if len(rewards) != len(samples):
            raise ValueError(
                f"reward_fn returned {len(rewards)} rewards for "
                f"{len(samples)} samples")
        # mutate the queue-shared objects: the learner pops these very
        # samples, so the scores travel with them
        for s, r in zip(samples, rewards):
            s.reward = r

    def iteration(self) -> Optional[WeightPublication]:
        """One rollout -> reward -> learn -> maybe-publish round.

        Returns the :class:`WeightPublication` when this round
        published (hand it to ``router.push_weights``), else None.
        """
        i = self.iterations
        prompts = self.prompts_fn(i)
        samples = self.engine.rollout(prompts, allow_stale=True,
                                      **self.rollout_kwargs)
        self._apply_rewards(samples)
        if self.critic is not None:
            # fit BEFORE the learner step: this round's advantages use
            # a head that has seen this round's returns
            self.critic.observe(samples)
        result = self.learner.step()
        if result is not None:
            self._steps_since_publish += 1
        self._m_staleness.set(self._steps_since_publish)
        self.iterations += 1
        self._m_iters.inc()
        pub = None
        if self.iterations % self.publish_every == 0 \
                and self._steps_since_publish:
            pub = self.engine.publish_delta()
            self.publishes += 1
            self._steps_since_publish = 0
            self._m_publishes.inc()
            self._m_staleness.set(0)
        return pub

    def run(self, iterations: int,
            publish_hook: Optional[
                Callable[[WeightPublication], None]] = None
            ) -> List[WeightPublication]:
        """Run ``iterations`` rounds synchronously; each publication is
        handed to ``publish_hook`` (e.g. a bridge into the router's
        event loop) and collected into the returned list."""
        pubs: List[WeightPublication] = []
        for _ in range(int(iterations)):
            pub = self.iteration()
            if pub is not None:
                pubs.append(pub)
                if publish_hook is not None:
                    publish_hook(pub)
        return pubs

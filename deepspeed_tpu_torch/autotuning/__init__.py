"""Profile-guided autotuning.

Port of ``deepspeed_tpu/autotuning`` (which imports no jax), a copy over
the port's own planners and telemetry. Three layers over the tunable
registry (``runtime/tunables.py``):

  * :mod:`capture` — workload capture & replay: serialize a
    flight-recorder ring or synthesize a load_bench-style trace into a
    versioned artifact; expand it into a deterministic replay schedule,
  * :mod:`offline` — :class:`OfflineTuner`: device-free coordinate
    descent over the registry's search ladders, scored on the runtime's
    own planners (bucket plans, ring wire bytes, prefetch plans) plus a
    queueing model over the replayed workload,
  * :mod:`online` — :class:`OnlineAdapter`: SLO-burn-driven nudging of
    the ``online=True`` knobs (decode window, admission token budget)
    between scheduler steps, hysteresis-armed, warmed windows only at
    steady state.

Entry points: ``python -m deepspeed_tpu_torch.launcher.runner
--autotuning tune|run`` (tunes, then exports the tuned config to every
rank via ``DS_TPU_AUTOTUNED_CONFIG``) and ``ServingConfig.autotune``
(the serving runtime ticks the online adapter).
"""

from .capture import (  # noqa: F401
    ARTIFACT_VERSION,
    capture_from_recorder,
    load,
    replay_schedule,
    save,
    simulate_queue,
    synthesize,
)
from .offline import OfflineTuner, serving_overrides  # noqa: F401
from .online import OnlineAdapter, OnlineAdapterConfig  # noqa: F401

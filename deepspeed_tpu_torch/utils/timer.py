"""Wall-clock and throughput timers.

Port of ``deepspeed_tpu/utils/timer.py`` (``_Timer`` :15,
``SynchronizedWallClockTimer`` :48, ``ThroughputTimer`` :82), the
reference's ``deepspeed/utils/timer.py``. A timer on the card brackets its
region with CUDA events on the current stream (the reference's
``CudaEventTimer``), so it measures the device's time and its ``stop``
does not wait; ``elapsed`` synchronizes on the last event. On the CPU it
reads ``time.perf_counter``.
"""

import time
from typing import Dict, List, Optional

from .logging import log_dist


class _Timer:
    def __init__(self, name: str, use_cuda: Optional[bool] = None):
        import torch

        self.name = name
        self.use_cuda = (torch.cuda.is_available() if use_cuda is None
                         else use_cuda)
        self._start = None
        self._pending: List = []   # (start, end) CUDA events not yet read
        self.elapsed_total = 0.0
        self.count = 0

    def _mark(self):
        if self.use_cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self._start = self._mark()

    def stop(self, reset=False, record=True):
        if self._start is None:
            return
        end = self._mark()
        if record:
            if self.use_cuda:
                self._pending.append((self._start, end))
            else:
                self.elapsed_total += end - self._start
            self.count += 1
        self._start = None

    def _drain(self):
        for s, e in self._pending:
            e.synchronize()
            self.elapsed_total += s.elapsed_time(e) / 1e3
        self._pending = []

    def elapsed(self, reset=True) -> float:
        """Seconds summed over the recorded regions."""
        self._drain()
        value = self.elapsed_total
        if reset:
            self.reset()
        return value

    def mean(self) -> float:
        self._drain()
        return self.elapsed_total / max(self.count, 1)

    def reset(self):
        self._pending = []
        self.elapsed_total = 0.0
        self.count = 0


class SynchronizedWallClockTimer:
    """Named-timer registry (reference utils/timer.py:43)."""

    def __init__(self, use_cuda: Optional[bool] = None):
        self.use_cuda = use_cuda
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.use_cuda)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown=False, ranks=None):
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks or [0])

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        return {n: self.timers[n].mean() * 1000.0 / normalizer
                for n in names if n in self.timers}


FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


class ThroughputTimer:
    """samples/sec reporting (reference utils/timer.py:198), on the host's
    clock around work the caller has synchronized."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, monitor_memory: bool = False):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self._start_time = None
        self.started = False
        self.last_duration: Optional[float] = None

    def start(self):
        self._start_time = time.perf_counter()
        self.started = True

    def stop(self, global_step=True, report_speed=False):
        if not self.started:
            return
        self.started = False
        self.global_step_count += 1
        self.last_duration = time.perf_counter() - self._start_time
        if self.global_step_count > self.start_step:
            self.total_elapsed_time += self.last_duration

    @property
    def avg_samples_per_sec(self) -> float:
        steps = self.global_step_count - self.start_step
        if steps <= 0 or self.total_elapsed_time == 0:
            return 0.0
        return self.batch_size * steps / self.total_elapsed_time

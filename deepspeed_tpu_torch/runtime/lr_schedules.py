"""Learning-rate schedules.

Port of ``deepspeed_tpu/runtime/lr_schedules.py`` (reference LRRangeTest,
OneCycle, WarmupLR, WarmupDecayLR and WarmupCosineLR). Each schedule is a
pure function ``step -> lr`` of the (host) optimizer step; the port
evaluates it in Python floats where the JAX package evaluates it in f32
inside the compiled step. :class:`LRScheduler` is the torch-like
``step()/get_lr()`` wrapper the engine returns.
"""

import math
from typing import Callable, Dict, Optional

LRFn = Callable[[int], float]  # step -> lr


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def constant_lr(lr: float) -> LRFn:
    return lambda step: float(lr)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> LRFn:
    """Reference WarmupLR (lr_schedules.py:626): warm up then hold."""

    def fn(step):
        step = float(step)
        frac = _clip(step / max(warmup_num_steps, 1), 0.0, 1.0)
        if warmup_type == "log":
            frac = (1.0 if step >= warmup_num_steps
                    else math.log1p(step) / math.log(warmup_num_steps + 1))
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> LRFn:
    """Reference WarmupDecayLR (lr_schedules.py:715): warmup then linear decay."""
    wu = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step):
        step = float(step)
        decay = _clip((total_num_steps - step)
                      / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return wu(step) if step < warmup_num_steps else warmup_max_lr * decay

    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, warmup_type: str = "linear") -> LRFn:
    """Reference WarmupCosineLR: linear warmup then cosine decay."""

    def fn(step):
        step = float(step)
        wu_frac = warmup_min_ratio + (1 - warmup_min_ratio) * _clip(
            step / max(warmup_num_steps, 1), 0.0, 1.0)
        prog = _clip((step - warmup_num_steps)
                     / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        cos = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * prog))
        ratio = wu_frac if step < warmup_num_steps else cos
        return warmup_max_lr * ratio

    return fn


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_ignored) -> LRFn:
    """Reference OneCycle (lr_schedules.py:361): triangular cycle + decay tail."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    cycle_len = cycle_first_step_size + second

    def fn(step):
        step = float(step)
        up = _clip(step / cycle_first_step_size, 0.0, 1.0)
        down = _clip((step - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
        in_cycle = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
            up if step < cycle_first_step_size else 1.0 - down)
        if decay_step_size > 0:
            decay_steps = max(step - cycle_len, 0.0) / decay_step_size
            tail = cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        else:
            tail = float(cycle_min_lr)
        return in_cycle if step < cycle_len else tail

    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> LRFn:
    """Reference LRRangeTest (lr_schedules.py:258): linearly growing probe LR."""

    def fn(step):
        step = float(step)
        interval = (math.floor(step / lr_range_test_step_size)
                    if lr_range_test_staircase else step / lr_range_test_step_size)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return fn


SCHEDULE_REGISTRY: Dict[str, Callable[..., LRFn]] = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "OneCycle": one_cycle,
    "LRRangeTest": lr_range_test,
}


def build_lr_schedule(sched_config, base_lr: float) -> LRFn:
    """From SchedulerConfig (type/params) or None -> constant base_lr."""
    if sched_config is None or sched_config.type is None:
        return constant_lr(base_lr)
    name = sched_config.type
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"unknown scheduler '{name}'; known: {sorted(SCHEDULE_REGISTRY)}")
    return SCHEDULE_REGISTRY[name](**sched_config.params)


class LRScheduler:
    """Stateful wrapper with the torch-like surface the reference returns."""

    def __init__(self, fn: LRFn, start_step: int = 0):
        self.fn = fn
        self.last_step = start_step

    def step(self, increment: int = 1):
        self.last_step += increment

    def get_lr(self):
        return [float(self.fn(self.last_step))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]

"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``).

The five schedules of the reference's surface (LRRangeTest, OneCycle,
WarmupLR, WarmupDecayLR, WarmupCosineLR), each a ``step -> lr`` function on
Python numbers: the lr is computed on the host and handed to the update as a
scalar, so reading it never waits for the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[int], float]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_: Any) -> Schedule:
    """Warmup then constant (reference ``WarmupLR``)."""
    warmup_num_steps = max(2, warmup_num_steps)
    log_den = math.log(warmup_num_steps)

    def schedule(step):
        step = float(step)
        if warmup_type == "log":
            frac = math.log(max(step, 1.0)) / log_den
        else:
            frac = step / warmup_num_steps
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _clip(frac, 0.0, 1.0)

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_: Any) -> Schedule:
    """Warmup then linear decay to 0 (reference ``WarmupDecayLR``)."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps:
            return warm(step)
        decay = (total_num_steps - step) / max(float(total_num_steps - warmup_num_steps), 1.0)
        return warmup_max_lr * _clip(decay, 0.0, 1.0)

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "log", base_lr: float = 0.001, **_: Any) -> Schedule:
    """Warmup (ratio of base lr) then cosine decay (reference ``WarmupCosineLR``)."""
    warm = warmup_lr(warmup_min_ratio * base_lr, base_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        step = float(step)
        if step < warmup_num_steps:
            return warm(step)
        progress = _clip((step - warmup_num_steps)
                         / max(float(total_num_steps - warmup_num_steps), 1.0), 0.0, 1.0)
        return base_lr * (cos_min_ratio
                          + (1 - cos_min_ratio) * 0.5 * (1 + math.cos(math.pi * progress)))

    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None, **_: Any) -> Schedule:
    """Triangular cycle then optional decay (reference ``OneCycle``)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    cycle_len = cycle_first_step_size + second

    def schedule(step):
        step = float(step)
        if step <= cycle_len:
            if step <= cycle_first_step_size:
                up = _clip(step / cycle_first_step_size, 0.0, 1.0)
                return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up
            down = _clip((step - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down
        if decay_step_size > 0:
            decay_steps = max(step - cycle_len, 0.0) / decay_step_size
            return cycle_min_lr / (1.0 + decay_steps * decay_lr_rate)
        return cycle_min_lr

    return schedule


def lr_range_test(lr_range_test_min_lr: float = 0.001, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_: Any) -> Schedule:
    """Increasing-LR sweep for tuning (reference ``LRRangeTest``)."""

    def schedule(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


_FACTORIES: Dict[str, Callable[..., Schedule]] = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    ONE_CYCLE: one_cycle,
    LR_RANGE_TEST: lr_range_test,
}


def get_lr_schedule(name: str, params: Dict[str, Any], base_lr: Optional[float] = None) -> Schedule:
    if name not in _FACTORIES:
        raise ValueError(f"Unknown scheduler {name!r}; valid: {VALID_LR_SCHEDULES}")
    params = dict(params)
    if name == WARMUP_COSINE_LR and base_lr is not None:
        params.setdefault("base_lr", base_lr)
    return _FACTORIES[name](**params)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(lr)

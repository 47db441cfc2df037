"""Learning-rate and loss-weight schedules: the port's copy of
mulactseg_tpu/utils/schedule.py.

poly_lr (:15-23): lr = max(base * (1 - t/T)^power, min_lr), evaluated at
the step count BEFORE the update, as optax evaluates its schedules.
ramp_up (:26-36): the adaptive loss weight of the online and top-1
pseudo-label criteria, a host float.
"""

from __future__ import annotations

import math


def poly_lr(base_lr: float, max_iters: int, power: float = 0.9,
            min_lr: float = 1e-6):
    """Returns a schedule fn step -> lr (Python float)."""

    def schedule(step: int) -> float:
        frac = max(1.0 - float(step) / max_iters, 0.0)
        return max(base_lr * frac ** power, min_lr)

    return schedule


def sigmoid_ramp_up(x: float, lamparam: float, scale: float) -> float:
    den = 1.0 + math.exp(-x / lamparam)
    return (2.0 / den - 1.0) * scale


def ramp_up(x: float, lamparam: float = 0.1, scale: float = 1.0,
            dorampup: bool = True) -> float:
    """The sigmoid ramp of x = step / total under dorampup, else 1.0; 1.0
    past x = 1 (the reference's utils/scheduler.py:15-28)."""
    if not dorampup or x > 1.0:
        return 1.0
    return sigmoid_ramp_up(x, lamparam, scale)

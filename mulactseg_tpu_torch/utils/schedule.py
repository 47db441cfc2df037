"""Poly learning-rate schedule (mulactseg_tpu/utils/schedule.py:15-23):
lr = max(base * (1 - t/T)^power, min_lr), evaluated at the step count
BEFORE the update, as optax evaluates its schedules."""

from __future__ import annotations


def poly_lr(base_lr: float, max_iters: int, power: float = 0.9,
            min_lr: float = 1e-6):
    """Returns a schedule fn step -> lr (Python float)."""

    def schedule(step: int) -> float:
        frac = max(1.0 - float(step) / max_iters, 0.0)
        return max(base_lr * frac ** power, min_lr)

    return schedule

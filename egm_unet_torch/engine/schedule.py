"""Learning-rate schedule (port of ``egm_unet_tpu/engine/schedule.py``): one
epoch of linear warm-up from the factor 1e-3, then the poly decay
``(1 - progress) ** 0.9``, the reference's formula, stepped per iteration.
The arithmetic is float32, as the JAX schedule's."""

from __future__ import annotations

import numpy as np


def warmup_poly_schedule(base_lr: float, num_step: int, epochs: int,
                         warmup: bool = True, warmup_epochs: int = 1,
                         warmup_factor: float = 1e-3, power: float = 0.9):
    """Returns ``schedule(step) -> lr`` (a Python float)."""
    if num_step <= 0 or epochs <= 0:
        raise ValueError(f"num_step {num_step} and epochs {epochs} must be positive")
    if not warmup:
        warmup_epochs = 0
    warmup_steps = warmup_epochs * num_step
    total_decay = (epochs - warmup_epochs) * num_step
    f32 = np.float32

    def schedule(step) -> float:
        s = f32(step)
        if warmup and s <= warmup_steps:
            factor = f32(1.0)
            if warmup_steps > 0:
                alpha = s / f32(warmup_steps)
                factor = f32(warmup_factor) * (f32(1.0) - alpha) + alpha
        else:
            with np.errstate(divide="ignore"):  # no decay epochs: factor 0
                progress = (s - f32(warmup_steps)) / f32(total_decay)
            factor = np.maximum(f32(1.0) - progress, f32(0.0)) ** f32(power)
        return float(f32(base_lr) * factor)

    return schedule

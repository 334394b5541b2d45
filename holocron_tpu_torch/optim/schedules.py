"""Learning-rate schedules, functions of the update count: the port's own copies of the
optax schedules that the trainer uses (``holocron_tpu/trainer/core.py:332-339``).

They are not ``torch.optim.lr_scheduler`` classes: ``OneCycleLR`` has other phases
and another step convention. Values are Python floats computed in double precision,
where optax computes in float32.
"""

import math
from typing import Callable, Dict, Optional

__all__ = ["constant_schedule", "cosine_decay_schedule", "cosine_onecycle_schedule", "piecewise_interpolate_schedule"]

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    """``init * ((1 - alpha) * (0.5 * (1 + cos(pi * min(t, T) / T))) ** exponent + alpha)``
    (optax ``cosine_decay_schedule``)."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay**exponent + alpha)

    return schedule


def piecewise_interpolate_schedule(init_value: float, boundaries_and_scales: Optional[Dict[int, float]] = None) -> Schedule:
    """Cosine interpolation between the accumulated scaled values at the boundaries
    (optax ``piecewise_interpolate_schedule('cosine', ...)``). An interval of length 0
    is skipped, where optax's formula divides by 0 and yields NaN."""
    boundaries, scales = zip(*sorted(boundaries_and_scales.items())) if boundaries_and_scales else ((), ())
    if not all(scale >= 0.0 for scale in scales):
        raise ValueError("`piecewise_interpolate_schedule` expects non-negative scale factors")
    bounds = (0, *boundaries)
    values = [init_value]
    for scale in scales:
        values.append(values[-1] * scale)

    def schedule(count: int) -> float:
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if bounds[-1] <= count else 0.0

    return schedule


def cosine_onecycle_schedule(
    transition_steps: int,
    peak_value: float,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """One cycle: cosine from ``peak / div_factor`` up to ``peak`` over the first
    ``pct_start`` of the steps, then down to ``peak / (div_factor * final_div_factor)``
    (optax ``cosine_onecycle_schedule``)."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    return piecewise_interpolate_schedule(
        peak_value / div_factor,
        {int(pct_start * transition_steps): div_factor, int(transition_steps): 1.0 / (div_factor * final_div_factor)},
    )

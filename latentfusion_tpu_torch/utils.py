"""Block-config strings and scalar schedules (counterpart of
``latentfusion_tpu/utils``)."""
from __future__ import annotations

import math
from bisect import bisect_right


def _parse_block(s: str):
    return s if s in ("I", "U", "D") else int(s)


def parse_block_config(s: str, delimiter: str = ",", group_delimiter: str = ":"):
    """``'64,D,128:512,U,256'`` -> ((64, 'D', 128), (512, 'U', 256)).

    These strings are stored in checkpoints; they parse exactly as in the
    JAX package."""
    if s.lower() == "none" or len(s) == 0:
        return ()

    def parse(sec):
        return tuple(_parse_block(b) for b in sec.split(delimiter)) if sec else ()

    if group_delimiter in s:
        return tuple(parse(sec) for sec in s.split(group_delimiter))
    return parse(s)


class LinearScheduler:
    """Linear ramp from ``initial_value`` to ``end_value`` over ``num_steps``."""

    def __init__(self, initial_value, end_value, num_steps):
        self.initial_value = initial_value
        self.end_value = end_value
        self.num_steps = num_steps

    def get(self, step):
        alpha = step / self.num_steps
        return (1.0 - alpha) * self.initial_value + alpha * self.end_value


class ExponentialScheduler:
    """Exponential decay from ``initial_value`` to ``final_value`` at step
    ``num_steps - 1``, held there afterwards."""

    def __init__(self, initial_value, final_value, num_steps):
        self.initial_value = initial_value
        self.final_value = final_value
        self.mean_lifetime = -(num_steps - 1) / math.log(final_value / initial_value)
        self.num_steps = num_steps

    def get(self, step):
        if step >= self.num_steps:
            return self.final_value
        return self.initial_value * math.exp(-step / self.mean_lifetime)


class MultiStepMilestoneScheduler:
    """``initial_value`` times ``gamma`` for every milestone at or below
    the step."""

    def __init__(self, initial_value, milestones, gamma):
        self.initial_value = initial_value
        self.milestones = milestones
        self.gamma = gamma

    def get(self, step):
        if self.milestones is None:
            return self.initial_value
        return self.initial_value * self.gamma ** bisect_right(self.milestones, step)

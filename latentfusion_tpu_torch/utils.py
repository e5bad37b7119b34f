"""Block-config strings, argument parsers, seeding, JSON and scalar
schedules (counterpart of ``latentfusion_tpu/utils``)."""
from __future__ import annotations

import json
import math
import pathlib
import random
from bisect import bisect_right
from functools import partial

import numpy as np
import torch


def seed_all(seed: int) -> None:
    """Seed ``random`` and ``np.random`` (the host streams the data path
    draws from, as in the JAX package) and torch's default generator."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def list_arg(cast_type=str, delimiter=","):
    """An argparse ``type``: ``'a,b'`` -> ``[cast(a), cast(b)]``, ``''`` -> []."""

    def f(s):
        if len(s) > 0:
            return [cast_type(item) for item in s.split(delimiter)]
        return []

    return f


def block_config_arg(delimiter=",", group_delimiter=":"):
    """An argparse ``type`` parsing a block-config string."""
    return partial(parse_block_config, delimiter=delimiter,
                   group_delimiter=group_delimiter)


class MyEncoder(json.JSONEncoder):
    """JSON for paths, numpy arrays and tensors (as lists)."""

    def default(self, obj):
        if isinstance(obj, pathlib.PurePath):
            return str(obj)
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().numpy().tolist()
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return json.JSONEncoder.default(self, obj)


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


def piecewise_constant_schedule(init_value: float, boundaries_and_scales=None):
    """``optax.piecewise_constant_schedule``: step -> ``init_value`` times
    every scale whose boundary the step has reached."""
    items = sorted((boundaries_and_scales or {}).items())
    bounds = [b for b, _ in items]

    def schedule(step: int) -> float:
        value = init_value
        for _, scale in items[:bisect_right(bounds, step)]:
            value *= scale
        return value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``: step -> ``init_value`` times a cosine
    from 1 down to ``alpha`` over ``decay_steps``, held there after."""

    def schedule(step: int) -> float:
        progress = min(step, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * progress)) + alpha)

    return schedule

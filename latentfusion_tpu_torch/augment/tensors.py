"""Random crops and flips of (C, H, W) or (H, W) numpy arrays for data
workers (counterpart of ``latentfusion_tpu/augment/tensors.py``), drawing
from ``random`` in the JAX package's order."""
from __future__ import annotations

import random

import numpy as np


class TensorRandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x):
        if random.random() < self.p:
            return np.ascontiguousarray(x[..., ::-1])
        return x


class TensorRandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, x):
        if random.random() < self.p:
            return np.ascontiguousarray(x[..., ::-1, :])
        return x


def _pad_to(x, th, tw, mode="reflect"):
    h, w = x.shape[-2:]
    ph = max(0, th - h)
    pw = max(0, tw - w)
    if ph == 0 and pw == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(ph // 2, ph - ph // 2),
                                     (pw // 2, pw - pw // 2)]
    return np.pad(x, pad, mode=mode)


class TensorRandomCrop:
    def __init__(self, size, pad_if_needed: bool = False,
                 padding_mode: str = "reflect"):
        self.size = size if isinstance(size, tuple) else (size, size)
        self.pad_if_needed = pad_if_needed
        self.padding_mode = padding_mode

    def __call__(self, x):
        th, tw = self.size
        if self.pad_if_needed:
            x = _pad_to(x, th, tw, self.padding_mode)
        h, w = x.shape[-2:]
        i = random.randint(0, h - th)
        j = random.randint(0, w - tw)
        return x[..., i:i + th, j:j + tw]


class TensorCenterCrop:
    def __init__(self, size):
        self.size = size if isinstance(size, tuple) else (size, size)

    def __call__(self, x):
        th, tw = self.size
        h, w = x.shape[-2:]
        i = (h - th) // 2
        j = (w - tw) // 2
        return x[..., i:i + th, j:j + tw]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x

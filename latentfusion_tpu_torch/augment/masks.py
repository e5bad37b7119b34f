"""Mask corruptions for training on imperfect segmentation masks
(counterpart of ``latentfusion_tpu/augment/masks.py``).

Host numpy in data workers; ``random`` draws in the JAX package's order.
The OpenCV operations (morphology, rotation, filled ellipses) come from
``cv_compat``. The training stream's chain is ``default_mask_corruption``:
RandomAdd (p 0.15), RandomCut (p 0.05), RandomEllipses (p 0.2).
"""
from __future__ import annotations

import random
from abc import ABC, abstractmethod

import numpy as np

from . import cv_compat


def mask_to_tight_box(mask: np.ndarray):
    """(x_min, y_min, x_max, y_max) of the nonzero region."""
    ys, xs = np.nonzero(mask)
    return xs.min(), ys.min(), xs.max(), ys.max()


class MaskTransform(ABC):
    def __init__(self, p: float = 1.0):
        self.p = p

    def __call__(self, mask):
        m = np.asarray(mask).astype(bool)
        squeeze = m.ndim == 3 and m.shape[0] == 1
        if squeeze:
            m = m[0]
        if random.random() < self.p and m.any():
            m = self.apply(m)
        if squeeze:
            m = m[None]
        return m

    @abstractmethod
    def apply(self, mask: np.ndarray) -> np.ndarray:
        ...


class RandomMorphologicalTransform(MaskTransform):
    """Erosion, dilation, opening or closing with a random elliptical
    kernel."""

    def __init__(self, p=1.0, max_kernel: int = 11):
        super().__init__(p)
        self.max_kernel = max_kernel

    def apply(self, mask):
        k = random.randrange(3, self.max_kernel, 2)
        kernel = cv_compat.ellipse_kernel(k)
        op = random.choice(["erode", "dilate", "open", "close"])
        out = cv_compat.MORPH_OPS[op](mask, kernel)
        return out if out.any() else mask


class RandomTranslation(MaskTransform):
    """Translate the mask by a fraction of its extent."""

    def __init__(self, p=1.0, max_frac: float = 0.25):
        super().__init__(p)
        self.max_frac = max_frac

    def apply(self, mask):
        x0, y0, x1, y1 = mask_to_tight_box(mask)
        tx = int(random.uniform(-self.max_frac, self.max_frac) * (x1 - x0 + 1))
        ty = int(random.uniform(-self.max_frac, self.max_frac) * (y1 - y0 + 1))
        return np.roll(np.roll(mask, ty, axis=0), tx, axis=1)


class RandomRotation(MaskTransform):
    """Rotate the mask about its box centre (nearest neighbour)."""

    def __init__(self, p=1.0, max_deg: float = 20.0):
        super().__init__(p)
        self.max_deg = max_deg

    def apply(self, mask):
        h, w = mask.shape
        x0, y0, x1, y1 = mask_to_tight_box(mask)
        center = ((x0 + x1) / 2.0, (y0 + y1) / 2.0)
        angle = random.uniform(-self.max_deg, self.max_deg)
        M = cv_compat.rotation_matrix_2d(center, angle, 1.0)
        out = cv_compat.warp_affine_nearest(mask.astype(np.uint8), M, (w, h))
        return out.astype(bool) if out.any() else mask


class RandomEllipses(MaskTransform):
    """Add and remove random ellipses around the mask region."""

    def __init__(self, p=1.0, num_range=(1, 4), radius_frac=(0.05, 0.3)):
        super().__init__(p)
        self.num_range = num_range
        self.radius_frac = radius_frac

    def apply(self, mask):
        out = mask.astype(np.uint8)
        x0, y0, x1, y1 = mask_to_tight_box(mask)
        extent = max(x1 - x0 + 1, y1 - y0 + 1)
        ys, xs = np.nonzero(mask)
        for _ in range(random.randint(*self.num_range)):
            i = random.randrange(len(xs))
            cx, cy = int(xs[i]), int(ys[i])
            ax = max(1, int(random.uniform(*self.radius_frac) * extent))
            ay = max(1, int(random.uniform(*self.radius_frac) * extent))
            angle = random.uniform(0, 180)
            value = random.choice([0, 1])
            cv_compat.fill_ellipse(out, (cx, cy), (ax, ay), angle, value)
        return out.astype(bool) if out.any() else mask


class RandomAdd(MaskTransform):
    """Paste a shifted copy of the mask onto itself (false positives)."""

    def __init__(self, p=1.0, max_frac: float = 0.5):
        super().__init__(p)
        self.max_frac = max_frac

    def apply(self, mask):
        x0, y0, x1, y1 = mask_to_tight_box(mask)
        tx = int(random.uniform(0.1, self.max_frac) * (x1 - x0 + 1) * random.choice([-1, 1]))
        ty = int(random.uniform(0.1, self.max_frac) * (y1 - y0 + 1) * random.choice([-1, 1]))
        shifted = np.roll(np.roll(mask, ty, axis=0), tx, axis=1)
        return mask | shifted


class RandomCut(MaskTransform):
    """Cut a band from one side of the mask's box (occlusion)."""

    def __init__(self, p=1.0, max_frac: float = 0.4):
        super().__init__(p)
        self.max_frac = max_frac

    def apply(self, mask):
        x0, y0, x1, y1 = mask_to_tight_box(mask)
        out = mask.copy()
        side = random.randrange(4)
        fx = random.uniform(0.1, self.max_frac)
        w = x1 - x0 + 1
        h = y1 - y0 + 1
        if side == 0:  # left
            out[:, x0:x0 + int(fx * w)] = False
        elif side == 1:  # right
            out[:, x1 - int(fx * w):x1 + 1] = False
        elif side == 2:  # top
            out[y0:y0 + int(fx * h), :] = False
        else:  # bottom
            out[y1 - int(fx * h):y1 + 1, :] = False
        return out if out.any() else mask


class Compose:
    """Mask transforms in order (a class, so that datasets holding one
    pickle into spawned loader workers)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, mask):
        for t in self.transforms:
            mask = t(mask)
        return mask


def default_mask_corruption():
    """The training stream's mask-noise chain."""
    return Compose([RandomAdd(p=0.15), RandomCut(p=0.05), RandomEllipses(p=0.2)])

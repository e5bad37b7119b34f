"""Normalization and host augmentations (counterpart of
``latentfusion_tpu/augment/__init__.py``).

The normalizations act on torch tensors. The augmentations run in data
workers on numpy images and draw from ``random`` and ``np.random`` in the
JAX package's order, so a shared seed gives the same augmentation. OpenCV
is not used: its 8-bit HSV conversions, ``warpAffine`` and ``filter2D``
are reimplemented here in numpy and scipy (``cv_compat``).
"""
from __future__ import annotations

import random

import numpy as np
import torch

from .. import functional
from . import cv_compat

IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]


def gan_normalize(tensor: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return tensor * 2.0 - 1.0


def gan_denormalize(tensor: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> clamped [0, 1]."""
    return ((tensor + 1.0) / 2.0).clamp(0, 1)


def imagenet_normalize(tensor: torch.Tensor) -> torch.Tensor:
    return functional.normalize(tensor, IMAGENET_MEAN, IMAGENET_STD)


def imagenet_denormalize(tensor: torch.Tensor) -> torch.Tensor:
    return functional.denormalize(tensor, IMAGENET_MEAN, IMAGENET_STD).clamp(0, 1)


def add_noise(image, level: float = 0.1):
    """Additive gaussian noise with a random std in [0, level]."""
    std = random.uniform(0, level)
    out = np.asarray(image, dtype=np.float32)
    return np.clip(out + np.random.randn(*out.shape).astype(np.float32) * std, 0.0, 1.0)


def add_depth_noise(depth, level: float = 0.1):
    """Gaussian noise with a random std in [0, level] on the valid pixels."""
    std = random.uniform(0, level)
    out = np.asarray(depth, dtype=np.float32).copy()
    valid = out > 0
    out[valid] += np.random.randn(int(valid.sum())).astype(np.float32) * std
    return out


def motion_blur(image, max_kernel: int = 9):
    """A random directional blur: a line kernel of odd size in
    [3, max_kernel) rotated by a random angle, then correlated with the
    (H, W, C) float image (borders reflected without repeating the edge)."""
    k = random.randrange(3, max_kernel, 2)
    kernel = np.zeros((k, k), dtype=np.float32)
    kernel[k // 2, :] = 1.0 / k
    angle = random.uniform(0, 360)
    M = cv_compat.rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0)
    kernel = cv_compat.warp_affine_linear(kernel, M, (k, k))
    s = kernel.sum()
    if s > 0:
        kernel /= s
    return cv_compat.filter2d(np.asarray(image, dtype=np.float32), kernel)


def color_jitter(image, brightness=0.1, contrast=0.1, saturation=0.05, hue=0.05):
    """Random brightness, contrast, saturation and hue of an (H, W, 3) float
    image in [0, 1]; saturation and hue move in OpenCV's 8-bit HSV (H in
    0..179), as the JAX package does."""
    img = np.asarray(image, dtype=np.float32)
    b = 1.0 + random.uniform(-brightness, brightness)
    c = 1.0 + random.uniform(-contrast, contrast)
    mean = img.mean()
    img = np.clip((img * b - mean) * c + mean, 0, 1)
    hsv = cv_compat.rgb_to_hsv((img * 255).astype(np.uint8)).astype(np.float32)
    hsv[..., 1] *= 1.0 + random.uniform(-saturation, saturation)
    hsv[..., 0] = (hsv[..., 0] + random.uniform(-hue, hue) * 180) % 180
    hsv = np.clip(hsv, 0, [179, 255, 255]).astype(np.uint8)
    return cv_compat.hsv_to_rgb(hsv).astype(np.float32) / 255.0


from . import masks, tensors  # noqa: F401,E402

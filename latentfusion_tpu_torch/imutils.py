"""Mask morphology and mask statistics (counterpart of
``latentfusion_tpu/imutils.py``). ``largest_component`` labels with scipy
where the JAX package calls cv2, with cv2's 8-connectivity."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage


def _morph(mask: torch.Tensor, kernel_size: int, dilate: bool) -> torch.Tensor:
    """Square-window max (dilate) or min over the last two dims; the window
    only covers pixels inside the image."""
    x = mask.reshape(-1, 1, *mask.shape[-2:])
    pad = kernel_size // 2
    sign = 1.0 if dilate else -1.0
    out = sign * F.max_pool2d(sign * x, kernel_size, stride=1, padding=pad)
    return out.reshape(*mask.shape[:-2], *out.shape[-2:])


def dilate(mask: torch.Tensor, iterations: int = 1, kernel_size: int = 3) -> torch.Tensor:
    for _ in range(iterations):
        mask = _morph(mask, kernel_size, True)
    return mask


def erode(mask: torch.Tensor, iterations: int = 1, kernel_size: int = 3) -> torch.Tensor:
    for _ in range(iterations):
        mask = _morph(mask, kernel_size, False)
    return mask


def disk_kernel(radius: int) -> np.ndarray:
    """Disk structuring element matching ``skimage.morphology.disk``."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    if radius == 1:
        return (np.abs(x) + np.abs(y) <= radius).astype(np.float32)
    return ((x ** 2 + y ** 2) <= radius ** 2).astype(np.float32)


def erode_disk(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion of (..., H, W) masks with a disk: a pixel stays 1 only
    if the whole disk around it lies inside the mask (outside the image
    counts as 0)."""
    kernel = torch.from_numpy(disk_kernel(radius)).to(mask.device)
    x = mask.reshape(-1, 1, *mask.shape[-2:]).float()
    hits = F.conv2d(x, kernel[None, None], padding=radius)
    return (hits >= kernel.sum() - 1e-3).float().reshape(mask.shape)


def mean_color(color: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean color (B, 3) of (B, 3, H, W) over (B, 1, H, W) masks."""
    num = (color * mask).sum(dim=(-2, -1))
    return num / mask.sum(dim=(-2, -1)).clamp_min(eps)


def largest_component(mask: np.ndarray) -> np.ndarray:
    """The largest 8-connected component of a 2D mask (host side). Labels
    run in raster order of each component's first pixel, as cv2's do, so
    equal areas resolve to the first component."""
    mask = np.asarray(mask) > 0
    labels, num = ndimage.label(mask, structure=np.ones((3, 3), dtype=bool))
    if num == 0:
        return mask
    areas = np.bincount(labels.ravel())[1:]
    return labels == 1 + int(np.argmax(areas))

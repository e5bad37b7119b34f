"""Mask morphology (counterpart of the parts of ``latentfusion_tpu/imutils.py``
that pose initialization uses)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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

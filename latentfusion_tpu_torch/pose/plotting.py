"""Pose diagnostics images (counterpart of ``latentfusion_tpu/pose/plotting.py``;
its matplotlib plots are not ported: ROADMAP.md, Queue 1)."""
from __future__ import annotations

import numpy as np


def overlay_mask(color, mask, alpha: float = 0.5, channel: int = 0):
    """``mask`` added to one channel of ``color`` ((3, H, W) or (H, W, 3))
    and blended with it: (H, W, 3) float32."""
    color = np.asarray(color).astype(np.float32).copy()
    if color.ndim == 3 and color.shape[0] == 3:
        color = color.transpose(1, 2, 0)
    m = np.asarray(mask).astype(np.float32).reshape(*color.shape[:2])
    overlay = color.copy()
    overlay[..., channel] = np.clip(overlay[..., channel] + m, 0, 1)
    return (1 - alpha) * color + alpha * overlay

"""Image value normalization (counterpart of the normalization half of
``latentfusion_tpu/augment/__init__.py``)."""
from __future__ import annotations

import torch


def gan_normalize(tensor: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return tensor * 2.0 - 1.0


def gan_denormalize(tensor: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> clamped [0, 1]."""
    return ((tensor + 1.0) / 2.0).clamp(0, 1)

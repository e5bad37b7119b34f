"""2D grid sampling with ``F.grid_sample(align_corners=False)`` semantics
(counterpart of the 2D half of ``latentfusion_tpu/ops/grid_sample.py``;
the 3D volume sampler is ``ops/fused_sample.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(coord, size):
    """Map [-1, 1] grid coords to pixel coords (align_corners=False)."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def grid_sample_2d(input: torch.Tensor, grid: torch.Tensor,
                   mode: str = "bilinear",
                   padding_mode: str = "zeros") -> torch.Tensor:
    """input (N, C, H, W), grid (N, Ho, Wo, 2) with (x, y) in [-1, 1]."""
    return F.grid_sample(input.float(), grid.float(), mode=mode,
                         padding_mode=padding_mode, align_corners=False)

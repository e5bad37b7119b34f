"""Reconstruction helpers (counterpart of ``latentfusion_tpu/recon/utils.py``)."""
from __future__ import annotations

import torch


def get_normalized_voxel_coords(tensor: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, 3, D, H, W) coords in [-1, 1], stacked (z, y, x)."""
    lin = [torch.linspace(-1.0, 1.0, s, device=tensor.device)
           for s in tensor.shape[-3:]]
    coords = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=0)
    return coords[None].expand(tensor.shape[0], -1, -1, -1, -1)

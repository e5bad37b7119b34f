"""Multi-view volume fusion (counterpart of ``latentfusion_tpu/recon/fusion.py``;
the GRU fuser only, the default trained fuser)."""
from __future__ import annotations

import torch
from torch import nn

from ..modules.gru import ConvGRUCell
from .utils import get_normalized_voxel_coords


class GRUFuser(nn.Module):
    """Recurrent fold over views: the hidden state starts as view 0; each
    later view, with the normalized voxel coordinates appended, updates it.
    Maps (B, V, C, D, H, W) -> (B, 1, C, D, H, W)."""

    def __init__(self, in_channels: int, cube_size: float = 1.0):
        """``cube_size`` is accepted for checkpoint args; the fold does not
        read it."""
        super().__init__()
        self.gru = ConvGRUCell(in_channels + 3, in_channels, kernel_size=3, ndim=3)

    def forward(self, z_obj: torch.Tensor) -> torch.Tensor:
        h = z_obj[:, 0]
        coords = get_normalized_voxel_coords(h)
        for i in range(1, z_obj.shape[1]):
            h = self.gru(torch.cat((z_obj[:, i], coords), dim=1), h)
        return h[:, None]

"""3D conv GRU cell, the trained fuser's recurrence (counterpart of
``latentfusion_tpu/modules/gru.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .equalized import EqualizedConv


class ConvGRUCell(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int,
                 kernel_size: int = 3, ndim: int = 3):
        super().__init__()
        pad = kernel_size // 2
        both = in_channels + hidden_channels
        self.update_gate = EqualizedConv(both, hidden_channels, kernel_size,
                                         ndim=ndim, padding=pad)
        self.reset_gate = EqualizedConv(both, hidden_channels, kernel_size,
                                        ndim=ndim, padding=pad)
        self.out_gate = EqualizedConv(both, hidden_channels, kernel_size,
                                      ndim=ndim, padding=pad)

    def forward(self, x: torch.Tensor, h_cur: torch.Tensor) -> torch.Tensor:
        x_in = torch.cat([x, h_cur], dim=1)
        update = torch.sigmoid(self.update_gate(x_in))
        reset = torch.sigmoid(self.reset_gate(x_in))
        x_out = self.out_gate(torch.cat([x, h_cur * reset], dim=1))
        return h_cur * (1 - update) + x_out * update

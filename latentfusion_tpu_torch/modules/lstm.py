"""3D conv LSTM cell, the LSTM fuser's recurrence (counterpart of
``latentfusion_tpu/modules/lstm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .equalized import EqualizedConv


class ConvLSTMCell(nn.Module):
    """One conv over ``[x, h]`` to the 4 gates, split in the order i, f, o,
    g. Maps (x, (h, c)) -> (h', c')."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 kernel_size: int = 3, ndim: int = 3):
        super().__init__()
        self.conv = EqualizedConv(in_channels + hidden_channels,
                                  4 * hidden_channels, kernel_size, ndim=ndim,
                                  padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, state):
        h_cur, c_cur = state
        cc_i, cc_f, cc_o, cc_g = torch.chunk(self.conv(torch.cat([x, h_cur], dim=1)),
                                             4, dim=1)
        c_next = torch.sigmoid(cc_f) * c_cur + torch.sigmoid(cc_i) * torch.tanh(cc_g)
        return torch.sigmoid(cc_o) * torch.tanh(c_next), c_next

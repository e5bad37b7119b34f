"""Block-config DSL and conv blocks (counterpart of
``latentfusion_tpu/modules/blocks.py``).

``create_block_defs`` reproduces the reference's channel accounting,
including skip-connection widening, the ``in_views`` multiplier on the first
block, and the rule that a scale marker applies to the *next* conv block.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..functional import leaky_relu
from ..ops.interpolate import interpolate
from .equalized import EqualizedConv


def count_blocks(config) -> int:
    return sum(1 for b in config if isinstance(b, int)) - 1


def create_block_defs(config, ndim: int, scale_factor: float,
                      scale_mode: str = "bilinear", kernel_size: int = 3,
                      skip_connections: bool = False,
                      skip_connect_start: int = 1,
                      skip_connect_end: Optional[int] = None,
                      in_views: int = 1,
                      skip_connection_views: Optional[int] = None
                      ) -> List[Dict[str, Any]]:
    """Constructor kwargs for the ``Block``s of a config."""
    if ndim == 3 and scale_mode == "bilinear":
        scale_mode = "trilinear"
    if skip_connection_views is None:
        skip_connection_views = in_views
    num_blocks = count_blocks(config)
    if skip_connect_end is None:
        skip_connect_end = num_blocks
    skip_connect_end = min(num_blocks, skip_connect_end)

    defs = []
    num_conv_blocks = 0
    scale_next_block = 1.0
    block_in = config[0]
    for block_out in config[1:]:
        if isinstance(block_out, str) and block_out.isdigit():
            block_out = int(block_out)
        if isinstance(block_out, int):
            skip_in = 0
            if skip_connections and (
                    skip_connect_start <= num_conv_blocks < skip_connect_end):
                skip_in = block_in * skip_connection_views
            if num_conv_blocks == 0:
                block_in *= in_views
            defs.append(dict(in_channels=block_in + skip_in,
                             out_channels=block_out, kernel_size=kernel_size,
                             ndim=ndim, scale_mode=scale_mode,
                             scale_factor=scale_next_block))
            block_in = block_out
            num_conv_blocks += 1
            scale_next_block = 1.0
        elif block_out == "I":
            scale_next_block = scale_factor
        elif block_out == "U":
            scale_next_block = 2.0
        elif block_out == "D":
            scale_next_block = 0.5
        else:
            raise ValueError(f"Unknown block type {block_out!r}")
    return defs


class InputBlock(nn.Module):
    """1x1 conv then leaky-ReLU. As in the reference, the conv's stride is
    its kernel size."""

    def __init__(self, in_channels: int, out_channels: int, ndim: int = 2,
                 kernel_size: int = 1, relu_slope: float = 0.2):
        super().__init__()
        self.relu_slope = relu_slope
        self.conv = EqualizedConv(in_channels, out_channels, kernel_size,
                                  ndim=ndim, stride=kernel_size)

    def forward(self, x):
        return leaky_relu(self.conv(x), self.relu_slope)


class OutputBlock(nn.Module):
    """1x1 conv head with an optional activation."""

    _ACTIVATIONS = {None: lambda x: x, "none": lambda x: x,
                    "lrelu": lambda x: leaky_relu(x, 0.2),
                    "relu": F.relu, "tanh": torch.tanh}

    def __init__(self, in_channels: int, out_channels: int, ndim: int = 2,
                 activation: Optional[str] = None):
        super().__init__()
        if activation not in self._ACTIVATIONS:
            raise ValueError(f"Unknown activation type {activation}")
        self.activation = activation
        self.conv = EqualizedConv(in_channels, out_channels, 1, ndim=ndim)

    def forward(self, x):
        return self._ACTIVATIONS[self.activation](self.conv(x))


class Block(nn.Module):
    """conv -> lrelu(0.2) + PixelNorm, twice, then an optional resize."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, ndim: int = 3,
                 scale_factor: float = 1.0, scale_mode: str = "bilinear",
                 relu_slope: float = 0.2):
        super().__init__()
        self.relu_slope = relu_slope
        self.scale_factor = scale_factor
        self.scale_mode = scale_mode
        pad = kernel_size // 2
        self.conv1 = EqualizedConv(in_channels, out_channels, kernel_size,
                                   ndim=ndim, padding=pad)
        self.conv2 = EqualizedConv(out_channels, out_channels, kernel_size,
                                   ndim=ndim, padding=pad)

    def forward(self, x, skip_scale: bool = False):
        from . import lrelu_pixel_norm

        x = lrelu_pixel_norm(self.conv1(x), self.relu_slope)
        x = lrelu_pixel_norm(self.conv2(x), self.relu_slope)
        if not skip_scale and self.scale_factor not in (None, 1.0):
            x = interpolate(x, scale_factor=self.scale_factor,
                            mode=self.scale_mode)
        return x


class PreActivationBasicBlock(nn.Module):
    """Pre-activation residual block that halves the resolution: leaky-ReLU,
    conv, leaky-ReLU, conv, resize by 0.5, plus a 1x1 conv of the input
    resized by 0.5. No shipped configuration uses it."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, relu_slope: float = 0.2,
                 scale_mode: str = "bilinear", ndim: int = 2):
        super().__init__()
        self.relu_slope = relu_slope
        self.scale_mode = scale_mode
        self.conv1 = EqualizedConv(in_channels, out_channels, kernel_size,
                                   ndim=ndim, stride=stride, padding=1)
        self.conv2 = EqualizedConv(out_channels, out_channels, kernel_size,
                                   ndim=ndim, padding=1)
        self.shortcut = EqualizedConv(in_channels, out_channels, 1, ndim=ndim)

    def forward(self, x):
        shortcut = self.shortcut(interpolate(x, scale_factor=0.5, mode=self.scale_mode))
        x = self.conv1(leaky_relu(x, self.relu_slope))
        x = self.conv2(leaky_relu(x, self.relu_slope))
        return interpolate(x, scale_factor=0.5, mode=self.scale_mode) + shortcut

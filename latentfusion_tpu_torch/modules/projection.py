"""2D <-> 3D feature projections (counterpart of
``latentfusion_tpu/modules/projection.py``)."""
from __future__ import annotations

from torch import nn

from .equalized import EqualizedConv


class TileProjection2d3d(nn.Module):
    """conv1x1 -> lrelu + PixelNorm -> tile along a new depth axis."""

    def __init__(self, in_channels: int, out_channels: int, out_size: int,
                 relu_slope: float = 0.2):
        super().__init__()
        self.out_size = out_size
        self.relu_slope = relu_slope
        self.conv = EqualizedConv(in_channels, out_channels, 1, ndim=2)

    def forward(self, x):
        from . import lrelu_pixel_norm

        x = lrelu_pixel_norm(self.conv(x), self.relu_slope)
        return x[:, :, None].expand(-1, -1, self.out_size, -1, -1)


class FactorProjection2d3d(nn.Module):
    """conv1x1 to C*D channels -> lrelu + PixelNorm -> (C, D) split."""

    def __init__(self, in_channels: int, out_channels: int, out_size: int,
                 relu_slope: float = 0.2):
        super().__init__()
        self.out_channels = out_channels
        self.relu_slope = relu_slope
        self.conv = EqualizedConv(in_channels, out_channels * out_size, 1, ndim=2)

    def forward(self, x):
        from . import lrelu_pixel_norm

        x = lrelu_pixel_norm(self.conv(x), self.relu_slope)
        return x.reshape(x.shape[0], self.out_channels, -1, *x.shape[-2:])


class FactorProjection3d2d(nn.Module):
    """Fold depth into channels (flat index c*D + d) -> conv1x1 ->
    lrelu + PixelNorm."""

    def __init__(self, in_channels: int, out_channels: int, out_size: int,
                 relu_slope: float = 0.2):
        super().__init__()
        self.relu_slope = relu_slope
        self.conv = EqualizedConv(in_channels * out_size, out_channels, 1, ndim=2)

    def forward(self, x):
        from . import lrelu_pixel_norm

        x = x.reshape(x.shape[0], x.shape[1] * x.shape[2], *x.shape[3:])
        return lrelu_pixel_norm(self.conv(x), self.relu_slope)

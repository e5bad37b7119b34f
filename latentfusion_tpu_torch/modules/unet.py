"""U-Net from block configs (counterpart of
``latentfusion_tpu/modules/unet.py``).

Skip concatenations join up-block i >= 1 with the reversed list of down-block
outputs. ``final_scale`` and ``skip_final_scale`` let a caller run its own
1x1 heads below the last up-block's resize and resize their few output
channels instead (an exact commute of two linear maps on disjoint axes).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch
from torch import nn

from ..ops.interpolate import interpolate
from .blocks import Block, InputBlock, OutputBlock, count_blocks, create_block_defs


class BaseUNet(nn.Module):
    def __init__(self, in_channels: Optional[int],
                 out_channels: Union[None, int, Sequence[int]],
                 block_config: Any, ndim: int = 2):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.down_block_config, self.up_block_config = block_config
        if in_channels is not None:
            self.input_block = InputBlock(in_channels,
                                          self.down_block_config[0], ndim=ndim)
        self.down_blocks = nn.ModuleList(
            Block(**kw) for kw in create_block_defs(self.down_block_config,
                                                    ndim, 0.5))
        self.up_blocks = nn.ModuleList(
            Block(**kw) for kw in create_block_defs(
                self.up_block_config, ndim, 2.0, skip_connections=True,
                skip_connect_end=min(count_blocks(self.down_block_config),
                                     count_blocks(self.up_block_config))))
        last = self.up_block_config[-1]
        if isinstance(out_channels, int):
            self.output_block = OutputBlock(last, out_channels, ndim=ndim)
        elif out_channels is not None:
            self.output_block = nn.ModuleList(
                OutputBlock(last, c, ndim=ndim) for c in out_channels)

    def bottleneck_size(self, in_size: int) -> int:
        num_down = (self.down_block_config.count("I")
                    + self.down_block_config.count("D"))
        return in_size // (2 ** num_down)

    def output_size(self, in_size: int) -> int:
        num_up = self.up_block_config.count("I") + self.up_block_config.count("U")
        return self.bottleneck_size(in_size) * (2 ** num_up)

    @property
    def final_scale(self):
        """(scale_factor, scale_mode) of the last up-block's resize, or None
        (also when the up config has no block)."""
        if not len(self.up_blocks):
            return None
        block = self.up_blocks[-1]
        if block.scale_factor in (None, 1.0):
            return None
        return block.scale_factor, block.scale_mode

    def _heads(self):
        if self.out_channels is None:
            return []
        if isinstance(self.out_channels, int):
            return [self.output_block]
        return list(self.output_block)

    def forward(self, z: torch.Tensor, skip_final_scale: bool = False):
        if self.in_channels is not None:
            z = self.input_block(z)
        intermediate = []
        for block in self.down_blocks:
            z = block(z)
            intermediate.insert(0, z)

        heads = self._heads()
        # The heads run below the last resize when they are 1x1 convs with no
        # activation: the same values, at a fraction of the resize work.
        defer = (bool(heads) and self.final_scale is not None
                 and all(h.activation is None for h in heads))
        last = len(self.up_blocks) - 1
        for block_id, block in enumerate(self.up_blocks):
            if 1 <= block_id < len(intermediate):
                z = torch.cat((z, intermediate[block_id]), dim=1)
            skip = block_id == last and (skip_final_scale or defer)
            z = block(z, skip_scale=skip)

        if heads:
            z = torch.cat([h(z) for h in heads], dim=1)
            if defer and not skip_final_scale:
                z = interpolate(z, scale_factor=self.final_scale[0],
                                mode=self.final_scale[1])
        return z


class UNet2d(BaseUNet):
    """A 2D U-Net with its own input block and output heads, as the IBR
    generator is: ``UNet2d(in_channels, out_channels, block_config)``, with
    ``out_channels`` an int or a list of head widths."""

    def __init__(self, in_channels: Optional[int],
                 out_channels: Union[None, int, Sequence[int]],
                 block_config: Any):
        super().__init__(in_channels, out_channels, block_config, ndim=2)


class UNet3d(BaseUNet):
    """The 3D U-Net of the Blend fuser and the Photographer's occlusion
    module: ``UNet3d(in_channels, out_channels, block_config)``."""

    def __init__(self, in_channels: Optional[int],
                 out_channels: Union[None, int, Sequence[int]],
                 block_config: Any):
        super().__init__(in_channels, out_channels, block_config, ndim=3)

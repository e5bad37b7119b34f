"""PatchGAN discriminators with minibatch statistics (counterpart of
``latentfusion_tpu/pggan/discriminator.py``): a stack of 4x4 equalized
convs (stride 2, the last stride 1) with instance norm, the minibatch's
standard deviation as an extra channel of the last block, a 4x4 head; the
multi-scale discriminator runs one at 1x, 0.5x and 0.25x."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..functional import leaky_relu
from ..modules.equalized import EqualizedConv
from ..ops.interpolate import interpolate


def minibatch_mean_variance(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The mean over positions of the batch's standard deviation."""
    mean = x.mean(dim=0, keepdim=True)
    return torch.sqrt(((x - mean) ** 2).mean(dim=0) + eps).mean()


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d``'s default: each (sample, channel) normalized
    over its positions, no affine, no running statistics."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class DiscriminatorBlock(nn.Module):
    """[minibatch statistics channel] -> conv -> [instance norm] -> leaky ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 stride: int = 2, use_norm: bool = False,
                 minibatch_stats: bool = False, relu_slope: float = 0.2,
                 padding: int = 0):
        super().__init__()
        self.use_norm = use_norm
        self.minibatch_stats = minibatch_stats
        self.relu_slope = relu_slope
        self.conv = EqualizedConv(in_channels + minibatch_stats, out_channels,
                                  kernel_size, ndim=2, stride=stride, padding=padding)

    def forward(self, x):
        if self.minibatch_stats:
            mv = minibatch_mean_variance(x).expand(x.shape[0], 1, *x.shape[2:])
            x = torch.cat((x, mv), dim=1)
        x = self.conv(x)
        if self.use_norm:
            x = instance_norm_2d(x)
        return leaky_relu(x, self.relu_slope)


class Discriminator(nn.Module):
    """PatchGAN over (N, C, H, W), the input multiplied by ``mask`` first."""

    def __init__(self, in_channels: int, block_config: Optional[Sequence[int]] = None):
        super().__init__()
        cfg = tuple(block_config or (64, 128, 256, 512))
        blocks = [DiscriminatorBlock(in_channels, cfg[0], stride=2, padding=1)]
        for block_id, (cin, cout) in enumerate(zip(cfg[:-1], cfg[1:])):
            is_last = block_id == len(cfg) - 2
            blocks.append(DiscriminatorBlock(cin, cout, stride=1 if is_last else 2,
                                             use_norm=True, minibatch_stats=is_last,
                                             padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.output_block = EqualizedConv(cfg[-1], 1, 4, ndim=2, stride=1, padding=1)

    def forward(self, x, mask=None):
        if mask is not None:
            x = (mask[:, None] if mask.dim() == 3 else mask) * x
        for block in self.blocks:
            x = block(x)
        return self.output_block(x)


class MultiScaleDiscriminator(nn.Module):
    """``num_scales`` discriminators; between scales the input halves
    bilinearly and the mask by nearest. Returns the list of their
    responses. Built on ``device`` (default the GPU), with weights N(0, 1)
    from ``generator`` when one is given."""

    def __init__(self, in_channels: int, block_config: Optional[Sequence[int]] = None,
                 num_scales: int = 3, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.num_scales = num_scales
        self.discriminators = nn.ModuleList(
            Discriminator(in_channels, block_config) for _ in range(num_scales))
        if generator is not None:
            for m in self.modules():
                if isinstance(m, EqualizedConv):
                    m.reset_parameters(generator)
        self.to(resolve_device(device))

    def cancelled_parameters(self):
        """The names of the parameters that do not reach the output: the
        conv biases of the blocks with instance norm, which removes each
        channel's constant. Their gradient is zero up to rounding."""
        return {f"discriminators.{i}.blocks.{j}.conv.bias"
                for i, d in enumerate(self.discriminators)
                for j, block in enumerate(d.blocks) if block.use_norm}

    def forward(self, x, mask=None):
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]
        responses = []
        for scale, discriminator in enumerate(self.discriminators):
            responses.append(discriminator(x, mask))
            if scale != self.num_scales - 1:
                x = interpolate(x, scale_factor=0.5, mode="bilinear")
                if mask is not None:
                    mask = interpolate(mask, scale_factor=0.5, mode="nearest")
        return responses

"""PGGAN encoder-decoder with style-vector injection and progressive
intermediate inputs and outputs (counterpart of
``latentfusion_tpu/pggan/generator.py``; no tool of either package trains
it).

Each block resizes first, then runs conv -> leaky ReLU + PixelNorm twice;
the leaky ReLU + PixelNorm is ``modules.lrelu_pixel_norm`` (kernel K2 on
the card). Parameter names are the JAX package's, so
``recon.checkpoint.from_jax_params`` carries its weights across. The
modules are built on ``device`` (the card by default; pass ``device="cpu"``
without one), with weights N(0, 1) from ``generator`` when one is given.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..functional import leaky_relu
from ..modules import lrelu_pixel_norm
from ..modules.equalized import EqualizedConv
from ..ops.interpolate import interpolate
from ..zoo import init_weights_

DEFAULT_BLOCK_CONFIG = (32, 64, 128, 256, 512, 512)


def _place(module: nn.Module, device, generator: Optional[torch.Generator]) -> nn.Module:
    device = resolve_device(device)
    if generator is not None:
        init_weights_(module, generator)
    return module.to(device)


class _InputBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, relu_slope: float = 0.2):
        super().__init__()
        self.relu_slope = relu_slope
        self.conv = EqualizedConv(in_channels, out_channels, 1, ndim=2)

    def forward(self, x):
        return leaky_relu(self.conv(x), self.relu_slope)


class _OutputBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = EqualizedConv(in_channels, out_channels, 1, ndim=2)

    def forward(self, x):
        return self.conv(x)


class _Block(nn.Module):
    """resize -> (conv -> leaky ReLU + PixelNorm) x 2: the resize comes
    before the convs, unlike ``modules.blocks.Block``."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: float,
                 scale_mode: str = "nearest", relu_slope: float = 0.2):
        super().__init__()
        self.scale_factor = scale_factor
        self.scale_mode = scale_mode
        self.relu_slope = relu_slope
        self.conv1 = EqualizedConv(in_channels, out_channels, 3, ndim=2, padding=1)
        self.conv2 = EqualizedConv(out_channels, out_channels, 3, ndim=2, padding=1)

    def forward(self, x):
        x = interpolate(x, scale_factor=self.scale_factor, mode=self.scale_mode)
        x = lrelu_pixel_norm(self.conv1(x), self.relu_slope)
        return lrelu_pixel_norm(self.conv2(x), self.relu_slope)


class Encoder(nn.Module):
    """Input block(s), then one halving block per step of ``block_config``.
    Returns (the content code, every block's output)."""

    def __init__(self, in_channels: int, block_config: Sequence[int],
                 intermediate_inputs: bool = False, scale_mode: str = "nearest",
                 input_level: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = tuple(block_config)
        self.input_level = input_level
        input_blocks, encoder_blocks = [], []
        for block_id, (cin, cout) in enumerate(zip(cfg[:-1], cfg[1:])):
            if intermediate_inputs or block_id == 0:
                input_blocks.append(_InputBlock(in_channels, cin))
            encoder_blocks.append(_Block(cin, cout, 0.5, scale_mode))
        self.input_blocks = nn.ModuleList(input_blocks)
        self.encoder_blocks = nn.ModuleList(encoder_blocks)
        _place(self, device, generator)

    def forward(self, x):
        if self.input_level > 0:
            x = interpolate(x, scale_factor=2 ** (-self.input_level), mode="nearest")
        z = self.input_blocks[self.input_level](x)
        z_intermediates = []
        for block in self.encoder_blocks:
            z = block(z)
            z_intermediates.append(z)
        return z, z_intermediates


class Decoder(nn.Module):
    """The content code with the style vector broadcast over its positions,
    one doubling block per step of the reversed ``block_config`` (with the
    encoder's intermediates concatenated from the second on, when
    ``skip_connections``), and an output head."""

    _ACTIVATIONS = (None, "tanh", "clamp")

    def __init__(self, out_channels: int, block_config: Sequence[int],
                 intermediate_outputs: bool = False, style_size: int = 8,
                 skip_connections: bool = True, scale_mode: str = "nearest",
                 output_activation: Optional[str] = None, output_level: int = 0,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if output_activation not in self._ACTIVATIONS:
            raise ValueError(f"Unknown output activation {output_activation}")
        cfg = list(reversed(tuple(block_config)))
        cfg[0] += style_size
        self.style_size = style_size
        self.skip_connections = skip_connections
        self.output_activation = output_activation
        self.output_level = output_level
        num_blocks = len(cfg) - 1
        decoder_blocks, output_blocks = [], []
        for block_id, (cin, cout) in enumerate(zip(cfg[:-1], cfg[1:])):
            if skip_connections and block_id >= 1:
                cin *= 2
            decoder_blocks.append(_Block(cin, cout, 2.0, scale_mode))
            if intermediate_outputs or block_id == num_blocks - 1:
                output_blocks.append(_OutputBlock(cout, out_channels))
        self.decoder_blocks = nn.ModuleList(decoder_blocks)
        self.output_blocks = nn.ModuleList(output_blocks)
        _place(self, device, generator)

    def forward(self, z_content, z_content_intermediates=None, z_style=None):
        if z_style is None and self.style_size > 0:
            raise ValueError("z_style required when style_size > 0")
        if z_content_intermediates is None and self.skip_connections:
            raise ValueError("intermediates required for skip connections")
        z = z_content
        if z_style is not None:
            z_style = z_style.reshape(*z_style.shape, 1, 1).expand(
                *z_style.shape, *z_content.shape[2:])
            z = torch.cat((z_content, z_style), dim=1)
        for block_id, block in enumerate(self.decoder_blocks):
            if self.skip_connections and block_id >= 1:
                z = torch.cat((z, z_content_intermediates[-block_id - 1]), dim=1)
            z = block(z)
        y = self.output_blocks[-self.output_level - 1](z)
        if self.output_activation == "tanh":
            y = torch.tanh(y)
        elif self.output_activation == "clamp":
            y = y.clamp(-1, 1)
        return y


class EncoderDecoder(nn.Module):
    """``Encoder`` then ``Decoder`` over ``block_config`` (default
    ``DEFAULT_BLOCK_CONFIG``). Returns (the output, the content code)."""

    def __init__(self, in_channels: int, out_channels: int, block_config: Any = None,
                 intermediate_inputs: bool = False, style_size: int = 8,
                 skip_connections: bool = True, scale_mode: str = "bilinear",
                 output_activation: Optional[str] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = tuple(block_config or DEFAULT_BLOCK_CONFIG)
        self.skip_connections = skip_connections
        self.encoder = Encoder(in_channels, cfg, intermediate_inputs, scale_mode=scale_mode,
                               device=device, generator=generator)
        self.decoder = Decoder(out_channels, cfg, intermediate_inputs, style_size=style_size,
                               skip_connections=skip_connections, scale_mode=scale_mode,
                               output_activation=output_activation, device=device,
                               generator=generator)

    def forward(self, x, z_style=None):
        z_content, z_intermediates = self.encoder(x)
        if not self.skip_connections:
            z_intermediates = None
        return self.decoder(z_content, z_intermediates, z_style), z_content

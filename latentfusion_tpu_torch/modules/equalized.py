"""Equalized-learning-rate convolution (counterpart of
``latentfusion_tpu/modules/equalized.py``).

A bias-free conv (``module``) whose output is scaled at run time by the He
constant sqrt(2 / fan_in), then a separate ``bias``. It computes in the
compute dtype (``dtypes.py``) with fp32 parameters, and its output, bias
included, stays in it. The parameter names are
the reference checkpoint's: ``<name>.module.weight`` and ``<name>.bias``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..dtypes import get_compute_dtype

_CONVS = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


class EqualizedConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 ndim: int = 2, stride: int = 1, padding: int = 0):
        super().__init__()
        self.module = _CONVS[ndim](in_channels, out_channels, kernel_size,
                                   stride=stride, padding=padding, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = math.sqrt(2.0 / (in_channels * kernel_size ** ndim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights N(0, 1) drawn from ``generator``, biases zero."""
        w = self.module.weight
        w.copy_(torch.randn(w.shape, generator=generator,
                            device=generator.device).to(w.device))
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = get_compute_dtype()
        if dtype == torch.float32 and x.dtype == torch.float32:
            y = self.module(x) * self.scale
        else:
            # The He constant rounds to the compute dtype first, as in JAX.
            conv = self.module
            y = conv._conv_forward(x.to(dtype), conv.weight.to(dtype), None)
            y = y * torch.tensor(self.scale, dtype=dtype)
        return y + self.bias.to(y.dtype).reshape(1, -1, *([1] * (y.dim() - 2)))

"""VGG16 feature extractor for the perceptual loss (counterpart of
``latentfusion_tpu/modules/vgg.py``).

``VGG16Features.features`` is torchvision's VGG16 ``features`` stack, cut
after the last layer read, so its ``state_dict`` keys are torchvision's
(``features.<index>.weight``/``bias``). Weights are drawn at random:
pretrained ones are an external asset, loaded with
``load_torchvision_state_dict``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device

# torchvision vgg16.features: (kind, channels) by layer index.
VGG16_LAYOUT = (
    ("conv", 64), ("relu", None), ("conv", 64), ("relu", None), ("pool", None),
    ("conv", 128), ("relu", None), ("conv", 128), ("relu", None), ("pool", None),
    ("conv", 256), ("relu", None), ("conv", 256), ("relu", None), ("conv", 256),
    ("relu", None), ("pool", None),
    ("conv", 512), ("relu", None), ("conv", 512), ("relu", None), ("conv", 512),
    ("relu", None), ("pool", None),
    ("conv", 512), ("relu", None), ("conv", 512), ("relu", None), ("conv", 512),
    ("relu", None), ("pool", None),
)

DEFAULT_LAYERS = (3, 8, 15, 22, 27)
DEFAULT_LAYER_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)


class VGG16Features(nn.Module):
    """The activations at torchvision feature indices ``layers`` of a
    (B, 3, H, W) ImageNet-normalized input, in index order."""

    def __init__(self, layers: Sequence[int] = DEFAULT_LAYERS, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = tuple(layers)
        stack, in_ch = [], 3
        for kind, ch in VGG16_LAYOUT[:max(self.layers) + 1]:
            if kind == "conv":
                stack.append(nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch
            elif kind == "relu":
                stack.append(nn.ReLU())
            else:
                stack.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*stack)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu", generator=generator)
                nn.init.zeros_(m.bias)
        self.to(resolve_device(device))

    def load_torchvision_state_dict(self, state_dict) -> None:
        """Load the ``features.*`` weights this stack holds from a
        torchvision ``vgg16().state_dict()``."""
        own = self.state_dict()
        self.load_state_dict({k: v for k, v in state_dict.items() if k in own})

    def forward(self, x):
        outputs = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.layers:
                outputs.append(x)
        return outputs


def build_perceptual_loss(vgg: VGG16Features, layer_weights=DEFAULT_LAYER_WEIGHTS):
    """The perceptual loss on ``vgg``'s features, one value per item."""
    from ..losses import PerceptualLoss

    return PerceptualLoss(vgg, layer_weights, reduction=None)

"""Architecture constructors (counterpart of ``latentfusion_tpu/zoo.py``):
the flagship family (256² input, 256-channel 16³ latent), the demo family
(128² input, 128-channel 8³ latent; the committed learned checkpoints use
it) and the tiny test family.

Each constructor returns the module on ``device`` (default ``"cuda"``), with
weights drawn from ``generator`` when one is given.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .device import resolve_device
from .modules.equalized import EqualizedConv
from .recon.fusion import GRUFuser
from .recon.models import Photographer, Sculptor

FLAGSHIP_INPUT_SIZE = 256
SCULPTOR_IMAGE_CONFIG = (
    (64, "D", 128, "D", 196, "D", 256, "D", 512, "D", 512, "D", 512),
    (512, "U", 512, "U", 256),
)
SCULPTOR_CAMERA_CONFIG = (64, 128, 256)
SCULPTOR_OBJECT_CONFIG = (256, 256)
PHOTOGRAPHER_CAMERA_CONFIG = (256, 256)
PHOTOGRAPHER_IMAGE_CONFIG = (
    (256, "D", 512, "D", 512),
    (512, "U", 512, "U", 512, "U", 256, "U", 196, "U", 128, "U", 64),
)

DEMO_INPUT_SIZE = 128
DEMO_CAMERA_DIST = 5.78  # canonical zoom distance for unit-diameter objects
DEMO_SCULPTOR_IMAGE_CONFIG = (
    (32, "D", 64, "D", 96, "D", 128, "D", 256, "D", 256, "D", 256),
    (256, "U", 256, "U", 128),
)
DEMO_SCULPTOR_CAMERA_CONFIG = (32, 64, 128)
DEMO_SCULPTOR_OBJECT_CONFIG = (128, 128)
DEMO_PHOTOGRAPHER_CAMERA_CONFIG = (128, 128)
DEMO_PHOTOGRAPHER_IMAGE_CONFIG = (
    (128, "D", 256, "D", 256),
    (256, "U", 256, "U", 256, "U", 128, "U", 96, "U", 64, "U", 48),
)


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every equalized conv's weights N(0, 1) from ``generator`` (in
    module order) and zero its bias."""
    for m in module.modules():
        if isinstance(m, EqualizedConv):
            m.reset_parameters(generator)
    return module


def _place(module: nn.Module, device, generator: Optional[torch.Generator]):
    device = resolve_device(device)
    if generator is not None:
        init_weights_(module, generator)
    return module.to(device).eval()


def flagship_sculptor(input_size: int = FLAGSHIP_INPUT_SIZE, device="cuda",
                      generator=None) -> Sculptor:
    return _place(Sculptor(
        in_size=input_size, image_config=SCULPTOR_IMAGE_CONFIG,
        camera_config=SCULPTOR_CAMERA_CONFIG,
        object_config=SCULPTOR_OBJECT_CONFIG, projection_type="factor",
        input_color=True, input_depth=False, input_mask=True, cube_size=1.0,
        scale_mode="nearest"), device, generator)


def flagship_photographer(input_size: int = FLAGSHIP_INPUT_SIZE, device="cuda",
                          generator=None) -> Photographer:
    return _place(Photographer(
        in_size=input_size // 16, image_config=PHOTOGRAPHER_IMAGE_CONFIG,
        camera_config=PHOTOGRAPHER_CAMERA_CONFIG, object_config=None,
        projection_type="factor", predict_color=False, predict_depth=True,
        predict_mask=True, cube_size=1.0, scale_mode="nearest"),
        device, generator)


def flagship_fuser(device="cuda", generator=None) -> GRUFuser:
    return _place(GRUFuser(in_channels=256, cube_size=1.0), device, generator)


def demo_sculptor(input_depth: bool = True, device="cuda",
                  generator=None) -> Sculptor:
    return _place(Sculptor(
        in_size=DEMO_INPUT_SIZE, image_config=DEMO_SCULPTOR_IMAGE_CONFIG,
        camera_config=DEMO_SCULPTOR_CAMERA_CONFIG,
        object_config=DEMO_SCULPTOR_OBJECT_CONFIG, projection_type="factor",
        cube_size=1.0, scale_mode="nearest", input_color=True,
        input_depth=input_depth, input_mask=True), device, generator)


def demo_photographer(device="cuda", generator=None) -> Photographer:
    return _place(Photographer(
        in_size=DEMO_INPUT_SIZE // 16, image_config=DEMO_PHOTOGRAPHER_IMAGE_CONFIG,
        camera_config=DEMO_PHOTOGRAPHER_CAMERA_CONFIG, object_config=None,
        projection_type="factor", predict_color=False, predict_depth=True,
        predict_mask=True, cube_size=1.0, scale_mode="nearest"),
        device, generator)


def demo_fuser(device="cuda", generator=None) -> GRUFuser:
    return _place(GRUFuser(in_channels=128, cube_size=1.0), device, generator)


def tiny_sculptor(input_size: int = 16, device="cuda", generator=None) -> Sculptor:
    return _place(Sculptor(
        in_size=input_size, image_config=((4, "D", 8), (8,)),
        camera_config=(4, 4), object_config=(4, 4), projection_type="factor",
        cube_size=1.0), device, generator)


def tiny_photographer(input_size: int = 8, device="cuda",
                      generator=None) -> Photographer:
    return _place(Photographer(
        in_size=input_size, image_config=((4, "D", 8), (8, "U", 8, "U", 4)),
        camera_config=(4, 4), object_config=None, projection_type="factor",
        predict_depth=True, predict_mask=True, cube_size=1.0),
        device, generator)


def tiny_fuser(device="cuda", generator=None) -> GRUFuser:
    return _place(GRUFuser(in_channels=4, cube_size=1.0), device, generator)

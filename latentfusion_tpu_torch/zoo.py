"""Architecture constructors (counterpart of ``latentfusion_tpu/zoo.py``):
the flagship family (256² input, 256-channel 16³ latent), the demo family
(128² input, 128-channel 8³ latent; the committed learned checkpoints use
it), the mid family (the flagship's widths at 128² input, a 256-channel 8³
latent; the unseen-object rig's model-scale probe) and the tiny test
family.

Each constructor returns the module on ``device`` (default ``"cuda"``), with
weights drawn from ``generator`` when one is given. ``canonical_camera`` and
``random_view_cameras`` make the cameras of the accuracy rigs.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import three
from .camera import Camera
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


def demo_module_args(input_depth: bool = True) -> dict:
    """The demo family's Sculptor and Photographer arguments as the JAX
    modules' ``checkpoint_args()`` record them (a reference ``.pth``'s
    ``args``)."""
    common = {"relu_slope": 0.2, "cube_size": 1.0, "projection_type": "factor",
              "scale_mode": "nearest"}
    return {
        "sculptor": {"in_size": DEMO_INPUT_SIZE, "image_config": DEMO_SCULPTOR_IMAGE_CONFIG,
                     "camera_config": DEMO_SCULPTOR_CAMERA_CONFIG,
                     "object_config": DEMO_SCULPTOR_OBJECT_CONFIG,
                     "cube_activation_type": None, "input_color": True,
                     "input_depth": input_depth, "input_mask": True, **common},
        "photographer": {"image_config": DEMO_PHOTOGRAPHER_IMAGE_CONFIG,
                         "camera_config": DEMO_PHOTOGRAPHER_CAMERA_CONFIG,
                         "occlusion_config": False, "object_config": None, "in_views": 1,
                         "in_size": DEMO_INPUT_SIZE // 16, "skip_connections": False,
                         "predict_color": False, "predict_depth": True, "predict_mask": True,
                         **common}}


MID_INPUT_SIZE = 128


def mid_sculptor(input_depth: bool = True, device="cuda", generator=None) -> Sculptor:
    return _place(Sculptor(
        in_size=MID_INPUT_SIZE, image_config=SCULPTOR_IMAGE_CONFIG,
        camera_config=SCULPTOR_CAMERA_CONFIG, object_config=SCULPTOR_OBJECT_CONFIG,
        projection_type="factor", cube_size=1.0, scale_mode="nearest",
        input_color=True, input_depth=input_depth, input_mask=True), device, generator)


def mid_fuser(device="cuda", generator=None) -> GRUFuser:
    return _place(GRUFuser(in_channels=256, cube_size=1.0), device, generator)


def mid_photographer(device="cuda", generator=None) -> Photographer:
    return _place(Photographer(
        in_size=MID_INPUT_SIZE // 16, image_config=PHOTOGRAPHER_IMAGE_CONFIG,
        camera_config=PHOTOGRAPHER_CAMERA_CONFIG, object_config=None,
        projection_type="factor", predict_color=False, predict_depth=True,
        predict_mask=True, cube_size=1.0, scale_mode="nearest"), device, generator)


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


def canonical_camera(n: int, camera_dist: float = 1.5, device="cuda") -> Camera:
    """``n`` cameras with the LINEMOD-style intrinsic (f = 615, 640x480) at
    ``camera_dist`` from the object, identity rotations."""
    device = resolve_device(device)
    f, width, height = 615.0, 640, 480
    intrinsic = torch.tensor([[f, 0.0, width / 2], [0.0, f, height / 2],
                              [0.0, 0.0, 1.0]], device=device).repeat(n, 1, 1)
    quats = three.quaternion.identity(n, device=device)
    trans = torch.tensor([[0.0, 0.0, camera_dist]], device=device).repeat(n, 1)
    return Camera(intrinsic, three.to_extrinsic_matrix(trans, quats), z_span=0.5,
                  width=width, height=height, device=device)


def random_view_cameras(n: int, generator: torch.Generator,
                        camera_dist: float = DEMO_CAMERA_DIST,
                        device="cuda") -> Camera:
    """Random full-frame viewpoints around a unit object at ``camera_dist``
    (the accuracy rigs' reference views): uniform rotations, translation
    jittered by N(0, (0.1, 0.1, 0.25))."""
    device = resolve_device(device)
    quats = three.quaternion.random(n, generator).to(device)
    noise = torch.randn(n, 3, generator=generator, device=generator.device).to(device)
    trans = (torch.tensor([0.0, 0.0, camera_dist], device=device)
             + noise * torch.tensor([0.1, 0.1, 0.25], device=device))
    template = canonical_camera(1, camera_dist, device=device)
    return Camera(template.intrinsic.expand(n, 3, 4),
                  three.to_extrinsic_matrix(trans, quats), z_span=template.z_span,
                  width=template.width, height=template.height, device=device)

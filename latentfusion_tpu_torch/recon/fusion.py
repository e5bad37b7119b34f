"""Multi-view volume fusers (counterpart of ``latentfusion_tpu/recon/fusion.py``).

A fuser merges the per-view object-space volumes (B, V, C, D, H, W) into one
latent object (B, 1, C', D, H, W). Every fuser takes the JAX package's call
``(z_obj, z_cam_mid, z_obj_mid, camera) -> (z_fused, extra)``: ``z_cam_mid``
are the Sculptor's camera-block outputs mapped to object space, each (B, V,
...), which only the Blend fuser reads (``reads_camera_intermediates``);
``z_obj_mid`` its object-block outputs; ``camera`` the views' cameras, of
length B*V.

The Pool and Concat fusers have no parameters; Blend (a 3D U-Net of blend
weights), GRU (the default trained fuser) and LSTM do.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..camera import Camera
from ..device import resolve_device
from ..functional import absolute_max_pool
from ..modules.gru import ConvGRUCell
from ..modules.lstm import ConvLSTMCell
from ..modules.unet import UNet3d
from ..three.batchview import b2bv, bv2b
from ..three.stats import median
from ..transforms import camera_to_object
from .utils import get_normalized_voxel_coords, get_normalized_voxel_depth


POOL_TYPES = ("max", "abs_max", "mean", "median")


def pool_tensor(tensor: torch.Tensor, pool_type: str, dim: int = 0) -> torch.Tensor:
    """Pool along ``dim``, keeping it: ``max``, ``abs_max`` (the element of
    largest magnitude), ``mean`` or ``median`` (numpy's: the mean of the two
    middle values of an even count)."""
    if pool_type == "max":
        return tensor.amax(dim=dim, keepdim=True)
    if pool_type == "abs_max":
        return absolute_max_pool(tensor, dim)
    if pool_type == "mean":
        return tensor.mean(dim=dim, keepdim=True)
    if pool_type == "median":
        return median(tensor, dim).unsqueeze(dim)
    raise ValueError(f"Unknown pool_type value {pool_type}")


class PoolFuser(nn.Module):
    """Pool the views' volumes elementwise."""

    def __init__(self, pool_type: str = "mean"):
        super().__init__()
        if pool_type not in POOL_TYPES:
            raise ValueError(f"Unknown pool_type value {pool_type}")
        self.pool_type = pool_type

    def forward(self, z_obj, z_cam_mid=None, z_obj_mid=None, camera=None):
        return pool_tensor(z_obj, self.pool_type, dim=1), {}


class ConcatFuser(nn.Module):
    """Stack the views along the channels: (B, V, C, ...) -> (B, 1, V*C, ...)."""

    def forward(self, z_obj, z_cam_mid=None, z_obj_mid=None, camera=None):
        n, v, c = z_obj.shape[:3]
        return z_obj.reshape(n, 1, v * c, *z_obj.shape[3:]), {}


class BlendFuser(nn.Module):
    """A 3D U-Net predicts one blend weight a voxel of each view from the
    Sculptor's last camera-block output and the voxel depth; the weights are
    mapped to object space (``camera_to_object``, K1 at one channel),
    softmaxed over the views, and blend the views' volumes.

    As in the JAX package, the camera-block output it reads is already in
    object space (the Sculptor maps it) and is mapped again here."""

    reads_camera_intermediates = True

    def __init__(self, block_config: Any, in_channels: int, cube_size: float = 1.0):
        super().__init__()
        self.in_channels = in_channels
        self.cube_size = cube_size
        self.unet = UNet3d(in_channels + 1, 1, block_config)

    def compute_blend_weights(self, z_cam: torch.Tensor, camera: Camera) -> torch.Tensor:
        num_views = z_cam.shape[1]
        z_cam = bv2b(z_cam)
        w = self.unet(torch.cat((z_cam, get_normalized_voxel_depth(z_cam)), dim=1))
        w = b2bv(camera_to_object(w, camera, self.cube_size), num_views)
        return torch.softmax(w, dim=1)

    def forward(self, z_obj, z_cam_mid, z_obj_mid, camera):
        weights = self.compute_blend_weights(z_cam_mid[-1], camera)
        return (z_obj * weights).sum(dim=1, keepdim=True), {
            "blend_weights": weights.squeeze(2)}


class GRUFuser(nn.Module):
    """Recurrent fold over views: the hidden state starts as view 0; each
    later view, with the normalized voxel coordinates appended, updates it.
    ``cube_size`` is kept for checkpoint args; the fold does not read it."""

    def __init__(self, in_channels: int, cube_size: float = 1.0):
        super().__init__()
        self.in_channels, self.cube_size = in_channels, cube_size
        self.gru = ConvGRUCell(in_channels + 3, in_channels, kernel_size=3, ndim=3)

    def forward(self, z_obj, z_cam_mid=None, z_obj_mid=None, camera=None):
        h = z_obj[:, 0]
        coords = get_normalized_voxel_coords(h)
        for i in range(1, z_obj.shape[1]):
            h = self.gru(torch.cat((z_obj[:, i], coords), dim=1), h)
        return h[:, None], {}


class LSTMFuser(nn.Module):
    """The GRU fuser's fold with a conv LSTM cell; the cell state starts at
    zero."""

    def __init__(self, in_channels: int, cube_size: float = 1.0):
        super().__init__()
        self.in_channels, self.cube_size = in_channels, cube_size
        self.lstm = ConvLSTMCell(in_channels + 3, in_channels, kernel_size=3, ndim=3)

    def forward(self, z_obj, z_cam_mid=None, z_obj_mid=None, camera=None):
        h = z_obj[:, 0]
        c = torch.zeros_like(h)
        coords = get_normalized_voxel_coords(h)
        for i in range(1, z_obj.shape[1]):
            h, c = self.lstm(torch.cat((z_obj[:, i], coords), dim=1), (h, c))
        return h[:, None], {}


def get_fuser(fuser_type: str, in_channels: int, cube_size: float,
              block_config=None, device="cuda",
              generator: Optional[torch.Generator] = None) -> nn.Module:
    """The fuser of a training tool's ``--fuser-type``: ``pool:<max, abs_max,
    mean or median>``, ``concat``, ``blend`` (``block_config`` is its U-Net's),
    ``gru`` or ``lstm``, on ``device``, with weights N(0, 1) from
    ``generator`` when one is given."""
    from ..zoo import init_weights_

    device = resolve_device(device)
    if fuser_type.startswith("pool:"):
        fuser = PoolFuser(fuser_type.split(":", 1)[1])
    elif fuser_type == "concat":
        fuser = ConcatFuser()
    elif fuser_type == "blend":
        fuser = BlendFuser(block_config, in_channels, cube_size)
    elif fuser_type == "gru":
        fuser = GRUFuser(in_channels, cube_size)
    elif fuser_type == "lstm":
        fuser = LSTMFuser(in_channels, cube_size)
    else:
        raise ValueError(f"Unknown fuser type {fuser_type!r}")
    if generator is not None:
        init_weights_(fuser, generator)
    return fuser.to(device)


FUSER_TYPES = {cls.__name__: cls for cls in
               (PoolFuser, ConcatFuser, BlendFuser, GRUFuser, LSTMFuser)}


def fuser_from_checkpoint_args(type_name: str, args: Optional[dict]) -> nn.Module:
    """A fuser from its checkpoint ``type`` and ``args`` (on the CPU)."""
    if type_name not in FUSER_TYPES:
        raise ValueError(f"Unknown fuser type {type_name!r}")
    args = dict(args or {})
    args.pop("conv_module", None)
    return FUSER_TYPES[type_name](**args)

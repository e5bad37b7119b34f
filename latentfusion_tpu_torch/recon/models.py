"""Sculptor (2D -> 3D encoder) and Photographer (3D -> 2D decoder)
(counterpart of ``latentfusion_tpu/recon/models.py``).

Submodule names mirror the reference's attribute names, so reference
checkpoints load with ``load_state_dict``. Module boundaries keep the NC*
layout.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..augment import gan_normalize
from ..camera import Camera
from ..modules.blocks import Block, OutputBlock, create_block_defs
from ..modules.projection import (FactorProjection2d3d, FactorProjection3d2d,
                                  TileProjection2d3d)
from ..modules.unet import BaseUNet, UNet3d
from ..ops.interpolate import interpolate
from ..three.batchview import b2bv, bv2b
from ..transforms import camera_to_object, object_to_camera
from .utils import get_normalized_voxel_depth


def _blocks(config, scale_factor, scale_mode, **kwargs) -> nn.ModuleList:
    if not config:
        return nn.ModuleList()
    return nn.ModuleList(Block(**kw) for kw in create_block_defs(
        config, 3, scale_factor, scale_mode=scale_mode, **kwargs))


class Sculptor(nn.Module):
    """Encoder: per-view 2D U-Net -> 2D->3D projection -> camera-space 3D
    blocks (each output also unprojected to object space) -> camera->object
    transform -> object blocks -> output head."""

    def __init__(self, in_size: int, image_config: Any, camera_config: Any,
                 object_config: Any, relu_slope: float = 0.2,
                 cube_size: float = 1.0,
                 cube_activation_type: Optional[str] = None,
                 projection_type: str = "tile", input_color: bool = True,
                 input_depth: bool = False, input_mask: bool = True,
                 scale_mode: str = "bilinear"):
        super().__init__()
        self.in_size = in_size
        self.cube_size = cube_size
        self.input_color = input_color
        self.input_depth = input_depth
        self.input_mask = input_mask
        in_channels = 3 * input_color + input_depth + input_mask
        self.image_encoder = BaseUNet(in_channels, None, image_config)
        image_out_size = self.image_encoder.output_size(in_size)
        projections = {"tile": TileProjection2d3d, "factor": FactorProjection2d3d}
        if projection_type not in projections:
            raise ValueError(f"Unknown projection type {projection_type!r}")
        self.projection_block = projections[projection_type](
            image_config[1][-1], camera_config[0], image_out_size)
        self.camera_blocks = _blocks(camera_config, 0.5, scale_mode)
        self.object_blocks = _blocks(object_config, 0.5, scale_mode)
        out_channels = (object_config or camera_config)[-1]
        self.output_block = OutputBlock(out_channels, out_channels, ndim=3,
                                        activation=cube_activation_type)

    def forward(self, x: torch.Tensor, camera: Camera,
                camera_intermediates: bool = False):
        """x: (B*V, C, H, W) folded views; camera of length B*V. Returns
        (z_obj, z_cam_mid, z_obj_mid). ``z_cam_mid``, each camera block's
        output mapped to object space (one K1-fwd launch each), is computed
        only when ``camera_intermediates`` asks for it (the Blend fuser and
        the Photographer's skip connections read it), else it is empty."""
        z = self.projection_block(self.image_encoder(x))
        z_cam_mid = []
        for block in self.camera_blocks:
            z = block(z)
            if camera_intermediates:
                z_cam_mid.append(camera_to_object(z, camera, self.cube_size))
        z = z_cam_mid[-1] if z_cam_mid else camera_to_object(z, camera, self.cube_size)
        z_obj_mid = []
        for block in self.object_blocks:
            z = block(z)
            z_obj_mid.append(z)
        return self.output_block(z), z_cam_mid, z_obj_mid


def interpret_logits(logits: torch.Tensor, predict_color: bool,
                     predict_depth: bool, predict_mask: bool,
                     apply_mask: bool = False) -> dict:
    """Split decoder logits into color/depth/mask heads."""
    logits = logits.float()
    base = 0
    y = {}
    if predict_color:
        y["color_logits"] = logits[:, base:base + 3]
        y["color"] = torch.tanh(y["color_logits"])
        base += 3
    if predict_depth:
        y["depth_logits"] = logits[:, base:base + 1]
        y["depth"] = torch.tanh(y["depth_logits"])
        base += 1
    if predict_mask:
        y["mask_logits"] = logits[:, base:base + 1]
        y["mask"] = torch.sigmoid(y["mask_logits"])
    else:
        y["mask"] = (y["depth"].detach() > -1.0).float()
        y["mask_logits"] = 100 * y["mask"] + (-100) * (1.0 - y["mask"])
    if apply_mask and predict_mask:
        if predict_depth:
            y["depth"] = (y["depth"] + 1) * (y["mask"] > 0.5) - 1
        if predict_color:
            y["color"] = y["color"] * (y["mask"] > 0.5)
    return y


class Photographer(nn.Module):
    """Decoder: object-space 3D blocks -> object->camera transform ->
    camera-space 3D blocks -> optional occlusion module -> depth collapse
    (sum | factor) -> 2D U-Net -> per-output 1x1 heads.

    The occlusion module (``occlusion_config``) is a 3D U-Net over the
    camera volume and its voxel depth whose one output channel, softmaxed
    over depth, weights the volume and gives an expected depth ``z_depth``.
    It is sized by ``object_config[-1] + 1`` inputs, as in the JAX package,
    so it needs an object config whose last width is the camera blocks'.

    With ``skip_connections`` the forward takes the Sculptor's intermediates
    of the same views: each object block after the first concatenates an
    object-block output, and every camera block the camera-block output
    mapped back to camera space (``object_to_camera``), in reverse order.
    The JAX package reads ``skip_connect_start=True`` as 1, so its camera
    block 0 gets no skip width and its forward raises for every
    configuration; the port widens camera block 0 too, as the forward
    needs."""

    def __init__(self, in_size: int, image_config: Any, camera_config: Any,
                 object_config: Any, projection_type: str = "sum",
                 occlusion_config: Any = False, in_views: int = 1,
                 skip_connections: bool = False, relu_slope: float = 0.2,
                 cube_size: float = 1.0, predict_color: bool = False,
                 predict_depth: bool = True, predict_mask: bool = True,
                 scale_mode: str = "bilinear"):
        super().__init__()
        if projection_type not in ("sum", "factor"):
            raise ValueError(f"Unknown projection type {projection_type!r}")
        if occlusion_config and not object_config:
            raise ValueError("the occlusion module takes object_config[-1] + 1 "
                             "channels: it needs an object_config")
        self.cube_size = cube_size
        self.projection_type = projection_type
        self.skip_connections = skip_connections
        self.predict_color = predict_color
        self.predict_depth = predict_depth
        self.predict_mask = predict_mask
        self.object_blocks = _blocks(object_config, 2.0, scale_mode,
                                     in_views=in_views,
                                     skip_connections=skip_connections)
        self.occlusion_module = (UNet3d(object_config[-1] + 1, 1, occlusion_config)
                                 if occlusion_config else None)
        object_out_size = in_size * 2 ** (object_config.count("U")
                                          if object_config else 0)
        camera_out_size = object_out_size * 2 ** camera_config.count("U")
        self.camera_blocks = _blocks(camera_config, 2.0, scale_mode,
                                     skip_connections=skip_connections,
                                     skip_connect_start=0,
                                     skip_connection_views=in_views)
        if projection_type == "factor":
            self.projection_block = FactorProjection3d2d(
                camera_config[-1], image_config[0][0], out_size=camera_out_size)
        self.image_decoder = BaseUNet(None, None, image_config)
        self.out_size = self.image_decoder.output_size(camera_out_size)
        out_channels = [3] * predict_color + [1] * predict_depth + [1] * predict_mask
        self.output_blocks = nn.ModuleList(
            OutputBlock(image_config[1][-1], c, ndim=2) for c in out_channels)

    def cancelled_parameters(self):
        """The names of the parameters that do not reach the output: the
        occlusion module's output bias, a constant the softmax over depth
        removes. Their gradient is zero up to rounding."""
        if self.occlusion_module is None:
            return set()
        return {"occlusion_module.output_block.conv.bias"}

    def _compute_depth_weights(self, z_cam: torch.Tensor):
        """The occlusion module's weights, softmaxed over depth, at its own
        resolution and resized (nearest) to the camera volume's."""
        logits = self.occlusion_module(
            torch.cat((z_cam, get_normalized_voxel_depth(z_cam)), dim=1))
        resized = interpolate(logits, size=z_cam.shape[2], mode="nearest")
        return torch.softmax(logits, dim=2), torch.softmax(resized, dim=2)

    @staticmethod
    def _depth_from_weight(depth_weights: torch.Tensor) -> torch.Tensor:
        """The expected normalized voxel depth under the weights, (N, 1, H, W)."""
        return (get_normalized_voxel_depth(depth_weights) * depth_weights).sum(dim=2)

    def forward(self, z_obj: torch.Tensor, camera: Camera, z_cam_mid=None,
                z_obj_mid=None):
        """z_obj (B', C, D, H, W) with B' dividing len(camera): a shared
        latent runs its object blocks once and the sampler reads it in place
        for all of its cameras (with skip connections it is repeated to the
        views of the intermediates, ``len(camera)``). Returns (logits, z_2d,
        z_depth | None)."""
        if camera.length % z_obj.shape[0] != 0:
            raise ValueError(
                f"batch dimension of z_obj must divide len(camera) "
                f"({z_obj.shape[0]} vs {camera.length})")
        if self.skip_connections:
            if z_cam_mid is None or z_obj_mid is None:
                raise ValueError("intermediates required for skip connections.")
            z_obj = z_obj.repeat_interleave(camera.length // z_obj.shape[0], dim=0)
            z_cam_mid = [object_to_camera(z, camera, self.cube_size) for z in z_cam_mid]
        z = z_obj
        for block_id, block in enumerate(self.object_blocks):
            if self.skip_connections and block_id >= 1:
                z = torch.cat((z, z_obj_mid[-block_id - 1]), dim=1)
            z = block(z)
        z = object_to_camera(z, camera, self.cube_size)
        for block_id, block in enumerate(self.camera_blocks):
            if self.skip_connections:
                z = torch.cat((z, z_cam_mid[-block_id - 1]), dim=1)
            z = block(z)
        z_depth = None
        if self.occlusion_module is not None:
            weights, weights_resized = self._compute_depth_weights(z)
            z_depth = self._depth_from_weight(weights)
            z = z * weights_resized
        if self.projection_type == "sum":
            z = z.sum(dim=2)
        else:
            z = self.projection_block(z)
        # The 1x1 heads commute with the image decoder's trailing resize, so
        # they run below it and only their few channels are resized.
        final_scale = self.image_decoder.final_scale
        y = self.image_decoder(z, skip_final_scale=final_scale is not None)
        y = torch.cat([ob(y) for ob in self.output_blocks], dim=1)
        if final_scale is not None:
            y = interpolate(y, scale_factor=final_scale[0], mode=final_scale[1])
        return y, z, z_depth

    def interpret_logits(self, logits, apply_mask: bool = False) -> dict:
        return interpret_logits(logits, self.predict_color, self.predict_depth,
                                self.predict_mask, apply_mask=apply_mask)


def encode(sculptor: Sculptor, fuser: nn.Module, camera: Camera,
           color: torch.Tensor, depth: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-view encode of (B, V, C, H, W) views with a camera of length
    B*V: fold the views, run the sculptor, unfold, fuse. The Sculptor maps
    its camera-block outputs to object space only for a fuser that reads
    them (``reads_camera_intermediates``). Returns the latent object (B, 1,
    C, D, H, W)."""
    num_views = color.shape[1]
    x = []
    if sculptor.input_color:
        x.append(bv2b(color))
    if sculptor.input_depth:
        x.append(bv2b(depth))
    if sculptor.input_mask:
        x.append(gan_normalize(bv2b(mask)))
    z_obj, z_cam_mid, z_obj_mid = sculptor(
        torch.cat(x, dim=1), camera,
        camera_intermediates=getattr(fuser, "reads_camera_intermediates", False))
    z_fused, _ = fuser(b2bv(z_obj, num_views), [b2bv(z, num_views) for z in z_cam_mid],
                       [b2bv(z, num_views) for z in z_obj_mid], camera)
    return z_fused


def decode(photographer: Photographer, z_obj: torch.Tensor, camera: Camera,
           return_latent: bool = False, apply_mask: bool = False):
    """Render the latent objects (B, 1, C, D, H, W) from a camera of length
    B*V. The latent is not expanded to the V views: the sampler reads each
    object's volume for all of its views. Returns (y, z_2d | None, z_depth |
    None) with every entry of ``y`` and ``z_2d`` shaped (B, V, ...) and
    ``z_depth`` the occlusion module's depth (B*V, 1, H, W), None without
    one."""
    num_batch = z_obj.shape[0]
    num_views = camera.length // num_batch
    logits, z, z_depth = photographer(z_obj.reshape(num_batch, *z_obj.shape[2:]), camera)
    y = photographer.interpret_logits(logits, apply_mask=apply_mask)
    y = {k: b2bv(v, num_views) for k, v in y.items()}
    return y, (b2bv(z, num_views) if return_latent else None), z_depth


def autoencode(sculptor: Sculptor, fuser: nn.Module, photographer: Photographer,
               camera: Camera, color: torch.Tensor,
               depth: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None):
    """Encode (B, 1, C, H, W) single views and decode each latent at its own
    camera (length B). Returns (y, z_2d) with the view dim squeezed:
    entries of ``y`` (B, ...), ``z_2d`` the Photographer's 2D latent."""
    z_obj = encode(sculptor, fuser, camera, color, depth, mask)
    y, z, _ = decode(photographer, z_obj, camera, return_latent=True)
    return {k: v.squeeze(1) for k, v in y.items()}, z.squeeze(1)
